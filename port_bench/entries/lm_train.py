"""The ``lm_train`` entry: one training step of a decoder LM a job, the
port's normal step ``repro_torch.launch.train.train_step(params,
opt_state, inst_batches, cfg, opt_cfg, agg)``.

The configuration file names the port's architecture (``arch``, in
``repro_torch/configs/registry.py``) and states the model as run under
its source's keys (``pbench/lm_reference.py``'s ``Shape``), the
institutions, ``secure_agg`` (``"none"``: their plain float32 mean;
``"shamir"``: ``SecureCollective(backend="kernel")`` with the protocol
the file states), ``remat`` and the precision.  The program runs the
registry's configuration with those sizes put in; it refuses to run
where the port's model is not the one the reference computes (a dense
GQA decoder with SwiGLU) or where the program fixes a setting otherwise
than the file states.

The inputs are the initial weights, bf16, drawn on the card from the
configuration's ``weight_seed`` (``lm_reference.draw``); AdamW's moments
(float32) start at zero in the first step.  A job is a step's tokens:
each institution's ``batch`` sequences of ``seq_len`` ids, drawn on the
card from the job's own seed.  The answer is the step's metrics (loss,
``grad_norm``, lr, wire bytes).

What decides ``correct``: the warm-up's steps are the program's first
steps from the weight seed, and the window continues from them on the
same state.  After the window, the program's state freed, the reference
(``lm_reference.follow``, float32, TF32 off) follows those steps from the
same weights and tokens, and the comparison reads:

* ``loss_gap_first``: the first step's |loss - ref| / ref, from the same
  weights (bf16's rounding of the forward alone).  The later steps' loss
  is not compared: the weights' rounding to bf16 in each update moves it
  as far as the fp8 control and the faults do (``PERF.md`` §2);
* ``gnorm_gap_first``, ``gnorm_gap``: the same of the global grad norm
  (before the clip), the first step's and the later steps' largest;
* ``grad_gap``: each leaf's norm of the first gradient as AdamW took it
  (clipped), the program's worked out from its first moment after one
  step (mu / (1 - b1)), against the reference's: the largest |n - n_ref|
  over max(n_ref, the median leaf's n_ref);
* ``update_gap``: the same of each leaf's norm of its change over the
  warm-up's steps, read before the window's first step; leaves whose
  reference gradient is under a thousandth of the median leaf's move by
  rounding alone and are left out;
* ``wire_mismatch``, ``lr_mismatch``, ``nonfinite``: steps (warm-up and
  window) whose wire bytes differ from the protocol's count, whose rate
  differs from the schedule's, or whose loss or grad norm is not finite
  (exact).
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import statistics
import types

import numpy as np

from pbench import categories, compare, data, lm_reference, work

CATEGORIES = categories.TRAIN_CATEGORIES
NUMBERS = ("loss_gap_first", "gnorm_gap_first", "gnorm_gap", "grad_gap",
           "update_gap", "wire_mismatch", "lr_mismatch", "nonfinite")
COUNTS = ("wire_mismatch", "lr_mismatch", "nonfinite")
# the AdamW settings the reference models; a mix states every one
OPTIMIZER = {"lr", "b1", "b2", "eps", "weight_decay", "grad_clip",
             "warmup_steps"}
MIX = {"entry", "about", "batch", "seq_len", "optimizer", "warmup_jobs",
       "traced_jobs"}
# a leaf whose reference gradient is under this share of the median
# leaf's moves by rounding alone
STILL = 1e-3


def model_config(config: dict):
    """The port's model configuration as the file states it."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    base = get_config(config["arch"])
    kind = (base.family, base.mixer, base.attention, base.mlp_type,
            base.frontend, base.moe_num_experts, base.window)
    if kind != ("dense", "attn", "full", "swiglu", "tokens", 0, 0):
        raise ValueError(f"{config['arch']} is {kind}: the reference "
                         "computes a dense full-attention SwiGLU decoder")
    eps = inspect.signature(layers.rms_norm).parameters["eps"].default
    fixed = {"rms_norm_eps": eps, "tie_word_embeddings": False,
             "hidden_act": "silu", "qkv_bias": base.qkv_bias}
    stated = {k: config[k] for k in fixed}
    if fixed != stated:
        raise ValueError(f"the program fixes {fixed}; the configuration "
                         f"states {stated}")
    m = lm_reference.Shape.of(config)
    return dataclasses.replace(
        base, num_layers=m.layers, d_model=m.d, num_heads=m.heads,
        num_kv_heads=m.kv_heads, head_dim=m.head_dim, d_ff=m.ff,
        vocab_size=m.vocab, rope_theta=m.theta, remat=config["remat"],
        dtype_str=config["torch_dtype"])


class Inputs:
    """The initial weights in the program's tree, on the device; the
    program updates them in place, so they become its state."""

    def __init__(self, m: lm_reference.Shape, device):
        self.device = device
        self.params = {n: lm_reference.draw(m, n, device)
                       for n in lm_reference.TOP}
        self.params["segments"] = [{n: lm_reference.draw(m, n, device)
                                    for n in lm_reference.LAYER}]


def make_inputs(config: dict, seed: int, device) -> Inputs:
    """The weights, from the configuration's weight seed (every run's the
    same; the run's seed draws the tokens)."""
    return Inputs(lm_reference.Shape.of(config), device)


def jobs(mix: dict, seed: int, stream: int = 1):
    """Endless steps, each with its own token seed drawn from ``seed``;
    ``stream`` separates the warm-up's steps from the window's."""
    rng = np.random.default_rng(data.derive_seed(seed, stream))
    for i in itertools.count():
        yield {"index": i, "seed": int(rng.integers(0, 2**62))}


def wire_bytes(config: dict, m: lm_reference.Shape) -> int:
    """The protocol's share bytes of one step (``launch.train.
    wire_bytes``'s count for the kernel backend): every institution's
    gradient as a flat buffer of 128-wide rows, padded to a multiple of 8
    rows, sent as int32 shares, a slice a center a CRT residue; 0 for a
    plain mean."""
    if config["secure_agg"] == "none":
        return 0
    n = sum(int(np.prod(m.shapes()[k])) * (m.layers if k in
                                           lm_reference.LAYER else 1)
            for k in m.shapes())
    rows = -(-max(1, -(-n // 128)) // 8) * 8
    return (config["institutions"] * config["centers"]
            * len(config["moduli"]) * rows * 128 * 4)


def _leaves(tree, m: lm_reference.Shape) -> list:
    """A program tree's leaves in ``Shape.leaf_names``' order."""
    seg = tree["segments"][0]
    return [tree[n] for n in lm_reference.TOP] + [
        seg[n][i] for i in range(m.layers) for n in lm_reference.LAYER]


class Program:
    """The port's training step, configured as the file states."""

    def __init__(self, config: dict, mix: dict, device):
        from repro_torch.models import transformer as T
        from repro_torch.optim.adamw import AdamWConfig

        self.config, self.mix, self.device = config, mix, device
        self.m = lm_reference.Shape.of(config)
        self.cfg = model_config(config)
        self.opt_cfg = AdamWConfig(**mix["optimizer"])
        want = [(n, self.m.shapes()[n]) for n in lm_reference.TOP] + [
            (f"segments/0/{n}", (self.m.layers, *self.m.shapes()[n]))
            for n in lm_reference.LAYER]
        if T.param_shapes(self.cfg) != want:
            raise ValueError("the program's parameter tree is not the "
                             "one the harness draws")
        self.agg = None
        if config["secure_agg"] == "shamir":
            from repro_torch.core.collective import SecureCollective

            self.agg = SecureCollective(backend="kernel",
                                        overflow_check=True)
            scheme, codec = self.agg.scheme, self.agg.codec
            runs = {"threshold": scheme.threshold,
                    "centers": scheme.num_shares,
                    "moduli": list(scheme.field.moduli),
                    "frac_bits": codec.frac_bits}
            stated = {k: config[k] for k in runs}
            if runs != stated:
                raise ValueError(f"the program's protocol {runs} is not "
                                 f"the configuration's {stated}")
        elif config["secure_agg"] != "none":
            raise ValueError(f"secure_agg {config['secure_agg']!r}")
        self.inputs = self.state = None
        self.steps = 0

    def __call__(self, inputs: Inputs, job):
        from repro_torch.launch.train import train_step
        from repro_torch.optim.adamw import adamw_init

        if self.state is None:
            self.inputs, self.state = inputs, adamw_init(inputs.params)
        gen = None
        if self.agg is not None:
            gen = self.agg.round_key(job["seed"], job["index"], self.device)
        batches = lm_reference.batches(self.m, self.mix,
                                       self.config["institutions"], job,
                                       self.device)
        _, self.state, metrics = train_step(
            inputs.params, self.state, batches, self.cfg, self.opt_cfg,
            self.agg, gen)
        self.steps += 1
        answer = types.SimpleNamespace(**metrics, step=self.steps - 1,
                                       leaf_grad=None, leaf_change=None)
        if self.steps == 1:  # the first gradient as AdamW took it
            answer.leaf_grad = [n / (1.0 - self.opt_cfg.b1) for n in
                                lm_reference.norms(_leaves(self.state.mu,
                                                           self.m))]
        if self.steps == self.mix["warmup_jobs"]:  # before the window's
            p = inputs.params
            answer.leaf_change = lm_reference.change_norms(
                self.m, lambda n, i: p[n] if i is None
                else p["segments"][0][n][i], self.device)
        return answer

    def load_kernels(self) -> None:
        """Build the program's kernels, or load the build the checkout
        already holds (on the card; off it the program runs none)."""
        if self.device.type == "cuda":
            from repro_torch.kernels import _build

            _build.library()

    @staticmethod
    def counters() -> dict:
        from repro_torch.kernels import flash_attention, flash_attention_bwd

        return {"K7": flash_attention.flash_attention_kernel.launches,
                "K8a": flash_attention_bwd.flash_dq_kernel.launches,
                "K8b": flash_attention_bwd.flash_dkdv_kernel.launches}

    def free(self) -> None:
        """The weights, moments and collective: the program's state."""
        if self.inputs is not None:
            self.inputs.params = None
        self.inputs = self.state = self.agg = None


class Control:
    """The reference put in the program's place with its matrix products
    in fp8 (``lm_reference.fp8_matmul``): the step below the
    configuration's bf16 that would tempt a later change."""

    def __init__(self, config: dict, mix: dict, device):
        self.config, self.mix, self.device = config, mix, device
        self.m = lm_reference.Shape.of(config)
        self.trainer = None

    def __call__(self, inputs, job):
        if self.trainer is None:
            self.trainer = lm_reference.Trainer(
                self.m, self.mix["optimizer"], self.device,
                lm_reference.fp8_matmul)
        out = self.trainer.step(lm_reference.batches(
            self.m, self.mix, self.config["institutions"], job,
            self.device))
        t = self.trainer.t
        return types.SimpleNamespace(
            **out, bytes=wire_bytes(self.config, self.m), step=t - 1,
            leaf_grad=self.trainer.leaf_grad if t == 1 else None,
            leaf_change=self.trainer.leaf_change()
            if t == self.mix["warmup_jobs"] else None)

    def load_kernels(self) -> None:
        pass

    @staticmethod
    def counters() -> dict:
        return {"K7": 0, "K8a": 0, "K8b": 0}

    def free(self) -> None:
        self.trainer = None


def control_jobs(mix: dict) -> int:
    """The control's readings are its warm-up's steps: no window step."""
    return 0


def job_record(answer, seconds: float) -> dict:
    return {"seconds": seconds}


def modelled(mix: dict) -> None:
    """Raise where the mix states what the reference does not model."""
    if set(mix) != MIX or set(mix["optimizer"]) != OPTIMIZER:
        raise ValueError(f"an lm_train mix states {sorted(MIX)} and the "
                         f"optimizer's {sorted(OPTIMIZER)}; this one "
                         f"{sorted(mix)}, {sorted(mix['optimizer'])}")
    if mix["warmup_jobs"] < 2:
        raise ValueError("the warm-up's steps are the ones compared: the "
                         "first and at least one after it")


def _rel(x: float, ref: float) -> float:
    return abs(x - ref) / abs(ref) if ref else abs(x)


def leaf_gap(mine, ref, keep=None) -> float:
    """The largest |n - n_ref| / max(n_ref, the median leaf's n_ref) over
    the leaves ``keep`` selects (all without it)."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return max(abs(mine[i] - ref[i]) / max(ref[i], med) for i in idx)


def _settings(config, mix, m, answer) -> dict:
    """A step's exact numbers.  The rate is the schedule's at the step
    (float32's rounding of it allowed)."""
    opt = mix["optimizer"]
    rate = opt["lr"] * min(1.0, (answer.step + 1)
                           / max(opt["warmup_steps"], 1))
    ok = all(np.isfinite([answer.loss, answer.grad_norm]))
    return {"wire_mismatch": int(answer.bytes != wire_bytes(config, m)),
            "lr_mismatch": int(abs(answer.lr - rate) > 1e-6 * rate),
            "nonfinite": int(not ok)}


def check(cell, inputs, warm: list, answers: list, seed: int):
    """(correct, checks, failed): the warm-up's steps against the
    reference's, every step's settings and finiteness."""
    config, mix = cell.config, cell.traffic
    m, device = lm_reference.Shape.of(config), inputs.device
    ref = lm_reference.follow(
        m, mix["optimizer"],
        [lambda job=job: lm_reference.batches(
            m, mix, config["institutions"], job, device)
         for job, _ in warm], device)
    keep = [g >= STILL * statistics.median(ref["leaf_grad"])
            for g in ref["leaf_grad"]]
    per_job = {}
    for i, (_, a) in enumerate(warm):
        nums = _settings(config, mix, m, a)
        if i == 0:
            nums["loss_gap_first"] = _rel(a.loss, ref["loss"][0])
            nums["gnorm_gap_first"] = _rel(a.grad_norm, ref["grad_norm"][0])
        else:
            nums["gnorm_gap"] = _rel(a.grad_norm, ref["grad_norm"][i])
        if a.leaf_grad is not None:
            nums["grad_gap"] = leaf_gap(a.leaf_grad, ref["leaf_grad"])
        if a.leaf_change is not None:
            nums["update_gap"] = leaf_gap(a.leaf_change,
                                          ref["leaf_change"], keep)
        per_job[f"warm{i}"] = nums
    for i, (_, a) in enumerate(answers):
        per_job[i] = _settings(config, mix, m, a)
    return compare.judge(per_job, cell.limits, COUNTS)


# -- the work of a step, for the per-layer readers ---------------------------

def attention_work(config: dict, mix: dict) -> dict:
    """K7, K8a and K8b's work a launch: one layer of one institution's
    batch (bf16)."""
    m = lm_reference.Shape.of(config)
    args = (mix["batch"], mix["seq_len"], m.heads, m.kv_heads, m.head_dim,
            2)
    return {"K7": work.k7_flash(*args), "K8a": work.k8a_flash_dq(*args),
            "K8b": work.k8b_flash_dkdv(*args)}


def step_flops(config: dict, mix: dict) -> int:
    """The model FLOPs of one step, recomputation not counted: 6 x the
    parameters a token multiplies by x the step's tokens, and attention's
    causal pairs three times their forward (K7's) operations."""
    m = lm_reference.Shape.of(config)
    tokens = config["institutions"] * mix["batch"] * mix["seq_len"]
    k7 = attention_work(config, mix)["K7"]
    return (6 * m.matmul_params() * tokens
            + 3 * k7.bf16 * m.layers * config["institutions"])
