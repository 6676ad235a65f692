"""Generator and runner of language-model training steps (the ``lm_train``
traffic).

The traffic file sets ``batch`` rows of ``seq`` tokens a step, drawn
uniformly over the whole vocabulary from the seed (the labels are the
next tokens: no padding), the optimizer and its schedule (``lr``,
``warmup_steps``, ``schedule_steps``) and ``checked_steps``.  Steps run
back to back through the train step of the port's
``launch/steps.py::make_train_step``, driven as ``launch/train.py`` drives
it: parameters, optimizer state and batch in, the same objects out
(updated in place).

The inputs are the benchmark's, made on the device from the seed: every
parameter in one draw each, as the port initialises it (embeddings and
the output head N(0, 1/d), each factorized projection's basis and blocks
at the fan-in-scaled standard deviation of Heroes' init, LayerNorm scales
1 and biases 0), and each step's tokens.  Set-up builds the step, the
parameters and the optimizer state once and trains the first
``checked_steps`` steps through the window's own call, keeping each
step's loss, each parameter's first gradient as the optimizer got it
(AdamW's first moment after step 1, over 1 - b1) and each parameter's
change after the checked steps.  After the window, with the program's
state freed, the reference trains the same steps from the same inputs in
float32 and the numbers below are held to the cell's limits.
"""

from __future__ import annotations

import contextlib
import statistics

import torch

B1 = 0.9  # AdamW's first-moment decay, the port's default


def leaf_specs(c):
    """Every parameter: ``(name, path in the port's tree, shape, init)``,
    init a standard deviation, ``"ones"`` or ``"zeros"``; in draw order."""
    d, f = c["hidden_size"], c["intermediate_size"]
    V, L = c["vocab_size"], c["num_hidden_layers"]
    comp = c["heroes_composition"]
    P, R, p = comp["max_width"], comp["rank"], comp["width"]
    out = [("embed", ("embed", "table"), (V, d), d ** -0.5),
           ("final_scale", ("final_norm", "scale"), (d,), "ones"),
           ("final_bias", ("final_norm", "bias"), (d,), "zeros"),
           ("unembed", ("unembed", "table"), (V, d), d ** -0.5)]
    lay = ("stack", "layers")
    for n in ("ln1", "ln2"):
        out += [(f"{n}_scale", lay + (n, "scale"), (L, d), "ones"),
                (f"{n}_bias", lay + (n, "bias"), (L, d), "zeros")]
    for name, group, din, dout in (
            ("wq", "attn", d, d), ("wk", "attn", d, d), ("wv", "attn", d, d),
            ("wo", "attn", d, d), ("gate", "mlp", d, f), ("up", "mlp", d, f),
            ("down", "mlp", f, d)):
        I, O = din // P, dout // P
        std = (1.0 / I / R) ** 0.25
        out += [(f"{name}.basis", lay + (group, name, "basis"), (L, I, R), std),
                (f"{name}.coeff", lay + (group, name, "coeff"),
                 (L, p * p, R, O), std)]
    return out


def draw_params(c, seed, device):
    """``(name, f32 tensor)`` of every parameter in draw order, from one
    generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device).manual_seed(seed)
    for name, _, shape, init in leaf_specs(c):
        if init == "ones":
            yield name, torch.ones(shape, device=device)
        elif init == "zeros":
            yield name, torch.zeros(shape, device=device)
        else:
            t = torch.randn(shape, generator=gen, device=device)
            yield name, t.mul_(init)


def batches(c, traffic, seed, device):
    """Endless ``(tokens, labels)`` of ``(batch, seq)``: uniform token ids
    from a generator of their own, labels the next tokens."""
    gen = torch.Generator(device).manual_seed((seed + 1) % 2 ** 64)
    shape = (traffic["batch"], traffic["seq"] + 1)
    while True:
        t = torch.randint(0, c["vocab_size"], shape, generator=gen,
                          device=device)
        yield t[:, :-1], t[:, 1:]


def model_config(c):
    """The port's ``ModelConfig`` for the configuration file."""
    from repro_torch.configs.base import CompositionConfig, ModelConfig

    if c["hidden_act"] != "silu" or c["use_qkv_bias"]:
        raise ValueError("the port's dense family runs SwiGLU without "
                         "projection biases")
    if c.get("as_run") != {"partial_rotary_factor": 1.0,
                           "layer_norm_eps": 1e-6}:
        raise ValueError("the port rotates every head dimension and its "
                         "LayerNorm takes epsilon 1e-6: the configuration's "
                         "as_run must say so")
    comp = c["heroes_composition"]
    return ModelConfig(
        arch_id="stablelm-3b", family="dense",
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"], activation="swiglu", norm="layernorm",
        rope_theta=float(c["rope_theta"]),
        max_seq=c["max_position_embeddings"],
        tie_embeddings=c["tie_word_embeddings"],
        param_dtype=c["param_dtype"], compute_dtype=c["compute_dtype"],
        remat=c["remat"],
        composition=CompositionConfig(enabled=True,
                                      max_width=comp["max_width"],
                                      rank=comp["rank"], width=comp["width"]))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree(c, flat):
    """The port's nested parameter tree from ``name -> tensor``."""
    tree = {}
    for name, path, _, _ in leaf_specs(c):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[name]
    return tree


def norm_gap(prog, ref, keep=None):
    """Worst parameter's gap between the program's norm and the
    reference's, over the larger of its reference norm and the median
    parameter's; ``keep`` masks parameters out."""
    med = statistics.median(ref)
    worst = 0.0
    for i, (a, b) in enumerate(zip(prog, ref)):
        if keep is not None and not keep[i]:
            continue
        worst = max(worst, abs(a - b) / max(b, med))
    return worst


def compare(got, ref):
    """The compared numbers of a run (the program's ``got``, or a control
    in its place) against the reference's ``ref``.  The loss is the first
    step's: the later steps' (kept as ``loss_gap_all``, not compared) move
    with the rounding noise that AdamW's per-element normalisation makes
    a full step of either sign.  Parameters whose
    reference gradient is under a thousandth of the median parameter's
    (nought to rounding, moved by AdamW's normalisation alone) are left
    out of the change."""
    med = statistics.median(ref["grad_norms"])
    keep = [g >= 1e-3 * med for g in ref["grad_norms"]]
    med_c = statistics.median(ref["change"])
    change = [abs(a - b) / max(b, med_c) if k else 0.0
              for a, b, k in zip(got["change"], ref["change"], keep)]
    loss = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                ref["losses"])]
    return {
        "loss_gap": loss[0],
        "loss_gap_all": max(loss),
        "grad_gap": norm_gap(got["grad_norms"], ref["grad_norms"]),
        "change_gap": norm_gap(got["change"], ref["change"], keep),
        "change_gap_median": statistics.median(
            [g for g, k in zip(change, keep) if k]),
        "change_gap_by_param": change,
    }


class Run:
    def __init__(self, cfg, traffic, seed, device, trace, reference):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = seed, torch.device(device)
        self.trace = trace
        self.ref = reference
        self.rate_metric = traffic["rate_metric"]
        self.failed = 0

    def _change(self, current):
        """Each parameter's norm of ``current[name]`` less its initial
        value, drawn again from the seed one parameter at a time."""
        with torch.no_grad():
            return [float(torch.linalg.vector_norm(current[n] - t0))
                    for n, t0 in draw_params(self.cfg, self.seed,
                                             self.device)]

    def setup(self):
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import cosine_schedule, make_optimizer

        c, t = self.cfg, self.traffic
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.mcfg = model_config(c)
        self.flat = dict(draw_params(c, self.seed, self.device))
        self.params = _tree(c, self.flat)
        opt = make_optimizer(t["optimizer"], cosine_schedule(
            t["lr"], t["schedule_steps"], t["warmup_steps"]))
        self.opt_state = opt.init(self.params)
        self.step_fn = make_train_step(self.mcfg, opt)
        self.data = batches(c, t, self.seed, self.device)
        got = {"losses": []}
        specs = leaf_specs(c)
        for i in range(t["checked_steps"]):
            metrics = self._step()
            got["losses"].append(float(metrics["loss"]))
            if i == 0:
                mu = self.opt_state["mu"]
                got["grad_norms"] = [
                    float(torch.linalg.vector_norm(_get(mu, path))) / (1 - B1)
                    for _, path, _, _ in specs]
        got["change"] = self._change(self.flat)
        self.got = got

    def _step(self):
        tokens, labels = next(self.data)
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, {"tokens": tokens, "labels": labels})
        return metrics

    def step(self):
        """One training step; returns its tokens."""
        self._step()
        return float(self.traffic["batch"] * self.traffic["seq"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self):
        del self.params, self.opt_state, self.step_fn, self.flat, self.data
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    def reference(self, control=False):
        c, t = self.cfg, self.traffic
        params = dict(draw_params(c, self.seed, self.device))
        data = batches(c, t, self.seed, self.device)
        steps = [next(data) for _ in range(t["checked_steps"])]
        out = self.ref.follow(params, steps, c, t, control=control)
        out["change"] = self._change(params)
        del params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def readings(self):
        return compare(self.got, self.reference())

    def control_readings(self):
        low = self.reference(control=True)
        return compare(low, self.reference())

    def check(self, limits):
        got = self.readings()
        checks = {k: (got[k], limits[k]) for k in limits}
        return all(v <= lim for v, lim in checks.values()), checks


@contextlib.contextmanager
def fault(name):
    """A fault planted in the program while the context lasts:
    ``unchanged`` (the optimizer's update is dropped: the step hands the
    parameters back as they came) and ``half_batch`` (the loss is taken on
    the first half of the batch's rows, the mean over them).  A training
    step produces no token or answer of its own to alter, and one chip
    exchanges nothing."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as model_lib

    if name == "unchanged":
        owner, attr = steps_lib, "apply_updates"

        def patched(params, updates):
            return params
    elif name == "half_batch":
        owner, attr = steps_lib.model, "loss_fn"
        inner = model_lib.loss_fn

        def patched(params, cfg, batch, skip_blocks=False):
            half = {k: v[:max(v.shape[0] // 2, 1)] for k, v in batch.items()}
            return inner(params, cfg, half, skip_blocks)
    else:
        raise ValueError(f"unknown fault {name!r}")
    saved = getattr(owner, attr)
    setattr(owner, attr, patched)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def make(cfg, traffic, seed, device, trace, reference):
    """The run of one cell; ``reference`` is the configuration's plain
    reference module."""
    return Run(cfg, traffic, seed, device, trace, reference)
