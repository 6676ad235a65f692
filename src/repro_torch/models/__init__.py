"""Model building blocks of the port: the parts of the JAX package's model
zoo that the composed transformer uses (RoPE and the chunked
streaming-softmax attention of :mod:`repro_torch.models.attention`)."""
