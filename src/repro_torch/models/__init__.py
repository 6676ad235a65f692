"""Model building blocks of the port.

* :mod:`repro_torch.models.attention` — RoPE and the chunked
  streaming-softmax attention the composed transformer trains through,
  and the zoo's attention block (prefill and KV-cache decode).
* The zoo's hybrid family (zamba2): :mod:`~repro_torch.models.module`,
  :mod:`~repro_torch.models.layers`, :mod:`~repro_torch.models.ssm`,
  :mod:`~repro_torch.models.transformer`,
  :mod:`~repro_torch.models.sampling` and the unified API in
  :mod:`~repro_torch.models.model`, served by
  :mod:`repro_torch.launch.serve`.
"""

from repro_torch.models import model  # noqa: F401
