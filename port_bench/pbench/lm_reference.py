"""The plain reference of the ``lm_train`` entry: a dense GQA decoder as
Qwen2.5 publishes it (the Qwen2 architecture), its next-token loss, the
institutions' gradient mean and AdamW, in plain PyTorch, in float32 with
TF32 off.  It imports nothing of the program and takes nothing the
program made: it draws the initial weights from the configuration's
``weight_seed`` and each step's tokens from the job's seed itself, with
the functions below that the harness also hands the program.

The model (``Shape`` reads it from the configuration file's published
keys): token embedding; per layer x += o(attn(rope(q), rope(k), v)) on
RMSNorm(x), q, k, v with biases, GQA (query head h reads key/value head
h // (heads / kv_heads)), causal softmax at head_dim^-0.5, rotary
embedding on the two halves of each head (theta ``rope_theta``), then
x += down(silu(gate(h)) * up(h)) on RMSNorm(x); a final RMSNorm and an
untied head; the mean cross-entropy over every position.  A step: each
institution's mean loss and its gradient, their mean over the
institutions, the gradient clipped to a global norm, AdamW (bias
corrections, decoupled weight decay).

Departures from the published model, each the program's, so that the two
compute one function:

* RMSNorm's epsilon is the configuration's ``rms_norm_eps`` as run, the
  program's fixed 1e-6 (``repro_torch/models/layers.py``); the file lists
  the published value beside it and the key in ``reduced``.
* A norm's gain is 1 + ``scale``, with ``scale`` the parameter (0 at the
  start, the published gain 1): the same function, but weight decay pulls
  ``scale`` towards 0, the gain towards 1.
* Weight decay acts on every parameter, the norms' scales and the biases
  among them.
* The matrices lie (in, out) and keep the program's names: ``wq``, ``wk``,
  ``wv``, ``wo``; ``w3`` the published ``gate_proj``, ``w1`` ``up_proj``,
  ``w2`` ``down_proj``.
* The vocabulary is one rank's slice of it (``vocab_size`` as run): ids
  are drawn from the slice and the logits and the loss are over it.

The initial weights (``draw``): every matrix, the embedding and the head
normal with standard deviation ``initializer_range``, drawn in bf16 on
the device from the configuration's ``weight_seed``, one call a stacked
leaf; the norms' scales and the biases 0, as Qwen2's initialisation sets
them.  Memory is kept to one sequence's activations at a time: each
sequence's loss is back-propagated alone and the gradients accumulate, and
each layer's activations are recomputed in the backward
(``torch.utils.checkpoint``).

``fp8_matmul`` is the control's product: both operands rounded to float8
e4m3 with one scale a tensor (its largest magnitude at e4m3's 448), as an
fp8 matrix product takes them, and multiplied in float32; the backward
passes through the rounding.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .data import derive_seed

TOP = ("embed", "final_norm", "lm_head")
LAYER = ("bk", "bq", "bv", "ln1", "ln2", "w1", "w2", "w3", "wk", "wo", "wq",
         "wv")
FP8_MAX = 448.0  # float8 e4m3's largest finite magnitude


@dataclasses.dataclass(frozen=True)
class Shape:
    """The model as run, from the configuration file's published keys."""

    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    theta: float
    eps: float
    init_std: float
    weight_seed: int

    @classmethod
    def of(cls, config: dict) -> "Shape":
        return cls(layers=config["num_hidden_layers"],
                   d=config["hidden_size"],
                   heads=config["num_attention_heads"],
                   kv_heads=config["num_key_value_heads"],
                   head_dim=config["head_dim"],
                   ff=config["intermediate_size"],
                   vocab=config["vocab_size"],
                   theta=float(config["rope_theta"]),
                   eps=float(config["rms_norm_eps"]),
                   init_std=float(config["initializer_range"]),
                   weight_seed=int(config["weight_seed"]))

    def shapes(self) -> dict:
        """Each leaf's shape: the top leaves' whole, a layer leaf's for one
        layer."""
        d, q, kv = self.d, self.heads * self.head_dim, \
            self.kv_heads * self.head_dim
        return {"embed": (self.vocab, d), "final_norm": (d,),
                "lm_head": (d, self.vocab),
                "bk": (kv,), "bq": (q,), "bv": (kv,), "ln1": (d,),
                "ln2": (d,), "w1": (d, self.ff), "w2": (self.ff, d),
                "w3": (d, self.ff), "wk": (d, kv), "wo": (q, d),
                "wq": (d, q), "wv": (d, kv)}

    def leaf_names(self) -> list[str]:
        """The leaves the comparison reads one by one: the top leaves and
        every layer's own."""
        return list(TOP) + [f"layers.{i}.{n}" for i in range(self.layers)
                            for n in LAYER]

    def matmul_params(self) -> int:
        """Parameters a token's forward multiplies by: every layer's
        matrices and the head (the embedding is a lookup)."""
        s = self.shapes()
        per_layer = sum(math.prod(s[n]) for n in LAYER if len(s[n]) == 2)
        return self.layers * per_layer + math.prod(s["lm_head"])


@contextlib.contextmanager
def exact_float32():
    """float32 products as float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def draw(m: Shape, name: str, device, dtype=torch.bfloat16):
    """The initial value of leaf ``name`` (a top leaf, or a layer leaf
    stacked over the layers, (layers, ...)), from the weight seed."""
    shape = m.shapes()[name]
    if name in LAYER:
        shape = (m.layers, *shape)
    if len(m.shapes()[name]) == 1:  # a norm's scale or a bias
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(m.weight_seed, sorted(TOP + LAYER)
                                .index(name)))
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(m.init_std)


def batches(m: Shape, mix: dict, institutions: int, job: dict, device):
    """The job's inputs: each institution's ``batch`` sequences of
    ``seq_len`` ids uniform over the vocabulary, drawn on the device from
    the job's seed, each label the next id."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(job["seed"]))
    ids = torch.randint(0, m.vocab, (institutions, mix["batch"],
                                     mix["seq_len"] + 1),
                        generator=gen, device=device)
    return [{"tokens": ids[j, :, :-1], "labels": ids[j, :, 1:]}
            for j in range(institutions)]


def _fp8(t):
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t).detach()


def fp8_matmul(a, b):
    return _fp8(a) @ _fp8(b)


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _rope(x, pos, theta):
    """x (S, heads, head_dim) rotated by position, the halves as pairs."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(0, 2 * half, 2, dtype=x.dtype,
                                         device=x.device) / (2 * half))
    ang = pos[:, None] * freqs
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v):
    """Causal GQA over one sequence: q (S, H, D), k, v (S, KVH, D)."""
    S, H, D = q.shape
    kvh = k.shape[1]
    q = q.reshape(S, kvh, H // kvh, D).permute(1, 2, 0, 3)
    k = k.permute(1, 0, 2)[:, None]
    v = v.permute(1, 0, 2)[:, None]
    s = (q @ k.transpose(-1, -2)) * D ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return (p @ v).permute(2, 0, 1, 3).reshape(S, H * D)


def _block(x, p, m: Shape, pos, mm):
    S = x.shape[0]
    h = _rms(x, p["ln1"], m.eps)
    q = (mm(h, p["wq"]) + p["bq"]).reshape(S, m.heads, m.head_dim)
    k = (mm(h, p["wk"]) + p["bk"]).reshape(S, m.kv_heads, m.head_dim)
    v = (mm(h, p["wv"]) + p["bv"]).reshape(S, m.kv_heads, m.head_dim)
    o = _attention(_rope(q, pos, m.theta), _rope(k, pos, m.theta), v)
    x = x + mm(o, p["wo"])
    h = _rms(x, p["ln2"], m.eps)
    return x + mm(F.silu(mm(h, p["w3"])) * mm(h, p["w1"]), p["w2"])


def sequence_loss(params, tokens, labels, m: Shape, mm=torch.matmul):
    """The mean next-token loss of one sequence (``tokens``, ``labels``
    (S,)), each layer's activations recomputed in the backward."""
    x = params["embed"][tokens]
    pos = torch.arange(tokens.shape[0], dtype=x.dtype, device=x.device)
    for p in params["layers"]:
        x = torch.utils.checkpoint.checkpoint(_block, x, p, m, pos, mm,
                                              use_reentrant=False)
    logits = mm(_rms(x, params["final_norm"], m.eps), params["lm_head"])
    return F.cross_entropy(logits, labels)


class Trainer:
    """The model's float32 parameters from the weight seed, AdamW's
    moments, and its steps.  ``opt``: the mix's AdamW settings (``lr``,
    ``b1``, ``b2``, ``eps``, ``weight_decay``, ``grad_clip``,
    ``warmup_steps``); ``mm``: the matrix product (``fp8_matmul`` for the
    control).

    After the first step ``leaf_grad`` holds each leaf's norm of the
    gradient as AdamW takes it (clipped), by ``Shape.leaf_names``."""

    def __init__(self, m: Shape, opt: dict, device, mm=torch.matmul):
        self.m, self.opt, self.device, self.mm = m, opt, device, mm
        top = {n: draw(m, n, device).float().requires_grad_()
               for n in TOP}
        stacked = {n: draw(m, n, device) for n in LAYER}
        layers = [{n: stacked[n][i].float().requires_grad_()
                   for n in LAYER} for i in range(m.layers)]
        del stacked
        self.params = dict(top, layers=layers)
        self.leaves = [self.params[n] for n in TOP] + [
            p[n] for p in layers for n in LAYER]
        self.mu = [torch.zeros_like(p) for p in self.leaves]
        self.nu = [torch.zeros_like(p) for p in self.leaves]
        self.t = 0
        self.leaf_grad = None

    def step(self, batches) -> dict:
        """One step on the institutions' ``batches``: (loss, grad_norm,
        lr) as the program reports them: the institutions' mean loss, the
        global norm of the mean gradient before clipping, the rate."""
        for p in self.leaves:
            p.grad = None
        n, loss = len(batches), 0.0
        with exact_float32():
            for b in batches:
                rows = b["tokens"].shape[0]
                for r in range(rows):
                    seq = sequence_loss(self.params, b["tokens"][r],
                                        b["labels"][r], self.m, self.mm)
                    (seq / (rows * n)).backward()
                    loss += float(seq.detach()) / (rows * n)
            return dict(self._adamw(), loss=loss)

    @torch.no_grad()
    def _adamw(self) -> dict:
        o = self.opt
        grads = [p.grad for p in self.leaves]
        gnorm = float(torch.sqrt(sum(g.pow(2).sum() for g in grads)))
        scale = min(1.0, o["grad_clip"] / max(gnorm, 1e-9)) \
            if o["grad_clip"] else 1.0
        self.t += 1
        lr = o["lr"] * min(1.0, self.t / max(o["warmup_steps"], 1))
        b1c, b2c = 1.0 - o["b1"] ** self.t, 1.0 - o["b2"] ** self.t
        for p, g, mu, nu in zip(self.leaves, grads, self.mu, self.nu):
            g = g * scale
            mu.mul_(o["b1"]).add_((1.0 - o["b1"]) * g)
            nu.mul_(o["b2"]).add_((1.0 - o["b2"]) * g * g)
            delta = (mu / b1c) / (torch.sqrt(nu / b2c) + o["eps"])
            p.sub_(lr * (delta + o["weight_decay"] * p))
        if self.t == 1:
            self.leaf_grad = norms([g * scale for g in grads])
        for p in self.leaves:
            p.grad = None
        return {"grad_norm": gnorm, "lr": lr}

    def leaf_change(self) -> list[float]:
        """Each leaf's norm of its change since the start."""
        p = self.params
        return change_norms(self.m, lambda n, i: p[n] if i is None
                            else p["layers"][i][n], self.device)


def _change(p, p0) -> torch.Tensor:
    return torch.linalg.vector_norm(p.detach().float() - p0.float())


@torch.no_grad()
def change_norms(m: Shape, leaf, device) -> list[float]:
    """Each leaf's norm of its change since ``draw``, by
    ``Shape.leaf_names``: ``leaf(name, None)`` is a top leaf's value now,
    ``leaf(name, i)`` layer i's."""
    out = {n: _change(leaf(n, None), draw(m, n, device)) for n in TOP}
    for n in LAYER:
        p0 = draw(m, n, device)
        for i in range(m.layers):
            out[f"layers.{i}.{n}"] = _change(leaf(n, i), p0[i])
    return torch.stack([out[k] for k in m.leaf_names()]).tolist()


def norms(tensors) -> list[float]:
    """Each tensor's norm, in float32, read back in one copy."""
    return torch.stack([torch.linalg.vector_norm(t.float())
                        for t in tensors]).tolist()


def follow(m: Shape, opt: dict, steps_batches, device,
           mm=torch.matmul) -> dict:
    """The reference's readings of the steps whose batches
    ``steps_batches`` lists (a callable a step, so that one step's tokens
    live at a time): each step's loss, grad norm and rate, the first
    step's ``leaf_grad`` and the ``leaf_change`` after the last."""
    trainer = Trainer(m, opt, device, mm)
    steps = [trainer.step(make()) for make in steps_batches]
    out = {k: [s[k] for s in steps] for k in ("loss", "grad_norm", "lr")}
    out["leaf_grad"] = trainer.leaf_grad
    out["leaf_change"] = trainer.leaf_change()
    return out
