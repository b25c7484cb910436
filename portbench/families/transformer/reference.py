"""The plain reference of the transformer family, in float32 with TF32
off: the serving logits by one causal forward pass over whole sequences
(no cache), and the first training steps (loss, gradients by autograd,
AdamW). It imports nothing of the program: it follows the configuration
file and the family's equations, and reads the benchmark's own weights,
upcast to float32 a layer at a time.

Equations, as the port runs them (``configs/*.json`` note where they
depart from the published models): pre-norm blocks, x += attn(norm1(x)),
x += mlp(norm2(x)); LayerNorm with scale and bias or RMSNorm with scale,
computed in float32; rotary positions on every head dim, the two halves
rotated (not interleaved pairs); causal softmax attention with query head
h reading kv head h // (H / Hk); SwiGLU MLPs; routed experts DeepSeekMoE
style: softmax router, top-k by probability (the lower index first among
equals), gates renormalised over the k, each group's assignments taken in
token-major order and an expert's beyond int(group * k * factor / E) + 1
dropped, plus the shared experts' MLP; loss = mean token cross-entropy +
aux_loss_alpha * the summed Switch balance loss (E * sum_e f_e P_e, the
mean over groups); AdamW with global-norm clipping, warm-up
lr * min((t + 1) / warmup, 1) at update t = 1, 2, ..., bias-corrected
moments and decoupled weight decay on every leaf.

``precision`` computes every product in a lower precision, for the
controls that ``calibrate.py`` reads: "tf32" rounds both operands of every
product (forward and backward) to TF32's 10-bit mantissa, "bf16" to
bfloat16, "fp8" to float8 e4m3 scaled by each row's (activations) or
column's (weights) largest magnitude; "f32" is the reference itself.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from portbench.families.transformer.layout import (norm_eps, padded_vocab,
                                                   stages)

QUERY_BLOCK = 512  # query rows of attention a pass, so scores fit


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the enclosed products (restored after)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


# ---------------------------------------------------------------------------
# products, in float32 or the control's lower precision
# ---------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest even), as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 after scaling each slice along ``dim`` to
    its largest magnitude (448), as float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _round(x, precision, dim):
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "tf32":
        return _tf32(x)
    if precision == "fp8":
        return _fp8(x, dim)
    return x


class _LowMatmul(torch.autograd.Function):
    """a @ b (equal batch dims) with both operands of the product and of
    its two gradient products rounded to ``precision``."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return _round(a, precision, -1) @ _round(b, precision, -2)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        pr = ctx.precision
        g_r = _round(g, pr, -1)
        ga = g_r @ _round(b, pr, -2).transpose(-1, -2) \
            if ctx.needs_input_grad[0] else None
        gb = _round(a, pr, -1).transpose(-1, -2) @ _round(g, pr, -2) \
            if ctx.needs_input_grad[1] else None
        return ga, gb, None


def matmul(a, b, precision="f32"):
    if precision == "f32":
        return a @ b
    return _LowMatmul.apply(a, b, precision)


def linear(x, w, precision="f32"):
    """x (..., d_in) @ w (d_in, d_out)."""
    return matmul(x.reshape(-1, x.shape[-1]), w, precision).reshape(
        *x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def norm(cfg, p, x):
    eps = norm_eps(cfg)
    if cfg["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt((x - mu).square().mean(-1, keepdim=True)
                                   + eps)
    else:
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    y = y * p["scale"]
    return y + p["bias"] if "bias" in p else y


def rope(x, theta):
    """x (N, L, heads, D): positions 0..L-1, halves of D rotated."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(cfg, p, x, precision="f32"):
    """Causal GQA self-attention of x (N, L, d)."""
    n, length, _ = x.shape
    h, hk, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    q = linear(x, p["wq"], precision)
    k = linear(x, p["wk"], precision)
    v = linear(x, p["wv"], precision)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(n, length, h, hd), cfg["rope_theta"])
    k = rope(k.reshape(n, length, hk, hd), cfg["rope_theta"])
    v = v.reshape(n, length, hk, hd)
    # (N, H, L, D), kv heads repeated over their query groups
    q = q.transpose(1, 2)
    k = k.repeat_interleave(h // hk, dim=2).transpose(1, 2)
    v = v.repeat_interleave(h // hk, dim=2).transpose(1, 2)
    scale = 1.0 / math.sqrt(hd)
    blocks = []
    for a in range(0, length, QUERY_BLOCK):
        b = min(a + QUERY_BLOCK, length)
        s = matmul(q[:, :, a:b], k[:, :, :b].transpose(-1, -2).contiguous(),
                   precision) * scale
        causal = torch.arange(b, device=x.device)[None, :] \
            <= torch.arange(a, b, device=x.device)[:, None]
        s = s.masked_fill(~causal, float("-inf"))
        blocks.append(matmul(torch.softmax(s, dim=-1),
                             v[:, :, :b].contiguous(), precision))
    out = torch.cat(blocks, dim=2).transpose(1, 2).reshape(n, length, h * hd)
    return linear(out, p["wo"], precision)


def swiglu(p, x, precision="f32"):
    h = F.silu(linear(x, p["w_gate"], precision)) \
        * linear(x, p["w_up"], precision)
    return linear(h, p["w_down"], precision)


def capacity(cfg, group: int) -> int:
    k, e = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    c = int(group * k * cfg["capacity_factor"] / e) + 1
    return max(1, min(c, group * k))


def moe(cfg, p, x, n_groups: int, precision="f32", probe=None):
    """Routed and shared experts of x (N, L, d). Returns (y, aux);
    ``probe``, a list, gets the router's probabilities (groups, group, E)."""
    n, length, d = x.shape
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    tokens = x.reshape(n_groups, -1, d)
    group = tokens.shape[1]
    probs = torch.softmax(linear(tokens, p["router"], precision), dim=-1)
    if probe is not None:
        probe.append(probs.detach())
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    gates = (top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)).reshape(-1)
    chosen = top_e.reshape(n_groups, group * k)  # token-major order
    onehot = F.one_hot(chosen, e)
    earlier = (onehot.cumsum(dim=1) - onehot).gather(2, chosen[..., None])
    kept = (earlier[..., 0] < capacity(cfg, group)).reshape(-1)
    frac = onehot.sum(dim=1).float() / (group * k)
    aux = (e * (frac * probs.mean(dim=1)).sum(-1)).mean()

    flat = x.reshape(-1, d)
    token = torch.arange(flat.shape[0], device=x.device).repeat_interleave(k)
    expert = chosen.reshape(-1)
    y = torch.zeros_like(flat)
    for i in range(e):
        sel = torch.nonzero((expert == i) & kept)[:, 0]
        if sel.numel() == 0:
            continue
        rows = token[sel]
        w = {name: p[name][i] for name in ("w_gate", "w_up", "w_down")}
        y = y.index_add(0, rows, swiglu(w, flat[rows], precision)
                        * gates[sel, None])
    y = y.reshape(n, length, d)
    if "shared" in p:
        y = y + swiglu(p["shared"], x, precision)
    return y, aux


def layers(cfg, params):
    """(kind, f32 parameters of one layer) in layer order, each upcast
    when it is reached."""
    for i, (kind, repeat) in enumerate(stages(cfg)):
        block = params["stages"][i]["L0"]
        for r in range(repeat):
            yield kind, _at(block, None if repeat == 1 else r)


def _at(tree, r):
    if isinstance(tree, dict):
        return {key: _at(sub, r) for key, sub in tree.items()}
    leaf = tree if r is None else tree[r]
    return leaf.float()


def hidden(cfg, params, tokens, n_groups: int, precision="f32", probe=None):
    """The final-norm output (N, L, d) of tokens (N, L) and the summed
    balance loss; ``probe`` as ``moe``'s, a layer after another."""
    x = params["embed"][tokens].float()
    aux = x.new_zeros(())
    for kind, p in layers(cfg, params):
        x = x + attention(cfg, p["mixer"], norm(cfg, p["ln1"], x), precision)
        h = norm(cfg, p["ln2"], x)
        if kind == "moe":
            y, a = moe(cfg, p["mlp"], h, n_groups, precision, probe)
            aux = aux + a
        else:
            y = swiglu(p["mlp"], h, precision)
        x = x + y
    return norm(cfg, _at(params["final_norm"], None), x), aux


def head(cfg, params, x, precision="f32"):
    """Logits over the vocabulary (padded rows -inf)."""
    w = params["embed"].float().T if cfg["tie_word_embeddings"] \
        else params["lm_head"].float()
    logits = linear(x, w, precision)
    if padded_vocab(cfg) != cfg["vocab_size"]:
        logits[..., cfg["vocab_size"]:] = float("-inf")
    return logits


@torch.no_grad()
def serve_logits(cfg, params, tokens, first: int, precision="f32"):
    """Logits (N, L - first, V) at positions first..L-1 of tokens (N, L),
    one dispatch group a sequence."""
    with exact_f32():
        x, _ = hidden(cfg, params, tokens, n_groups=tokens.shape[0],
                      precision=precision)
        return head(cfg, params, x[:, first:], precision)


def loss(cfg, params, batch, precision="f32", probe=None):
    tokens, labels = batch["tokens"], batch["labels"]
    x, aux = hidden(cfg, params, tokens, n_groups=tokens.shape[0],
                    precision=precision, probe=probe)
    logp = torch.log_softmax(head(cfg, params, x, precision), dim=-1)
    mask = labels >= 0
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    xent = (nll * mask).sum() / mask.sum().clamp_min(1)
    return xent + cfg.get("aux_loss_alpha", 0.0) * aux


def train(cfg, params: dict, batches, opt: dict, precision="f32",
          rows=None, router_probs=None):
    """Trains ``params`` ({name: float32 leaf}, updated in place) on
    ``batches`` with AdamW (``opt``: lr, b1, b2, eps, weight_decay,
    grad_clip, warmup_steps). ``rows`` keeps only those rows of every
    batch (a fault that leaves part of the batch out); ``router_probs``,
    a list, gets the first step's router probabilities of each MoE layer.
    Returns (each step's loss, {name: norm of the first step's clipped
    gradient})."""
    tree = _tree(params)
    names = list(params)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, first = [], None
    with exact_f32():
        for t, batch in enumerate(batches, 1):
            if rows is not None:
                batch = {key: val[rows] for key, val in batch.items()}
            for n in names:
                params[n].requires_grad_(True)
            value = loss(cfg, tree, batch, precision,
                         router_probs if t == 1 else None)
            grads = torch.autograd.grad(value, [params[n] for n in names])
            losses.append(value.item())
            with torch.no_grad():
                gn = torch.sqrt(sum(g.square().sum() for g in grads))
                scale = torch.clamp(opt["grad_clip"] / gn.clamp_min(1e-9),
                                    max=1.0)
                lr = opt["lr"] * min((t + 1) / max(opt["warmup_steps"], 1),
                                     1.0)
                b1c = 1.0 - opt["b1"] ** t
                b2c = 1.0 - opt["b2"] ** t
                if t == 1:
                    first = {}
                for n, g in zip(names, grads):
                    g = g * scale
                    if t == 1:
                        first[n] = float(torch.linalg.vector_norm(
                            g, dtype=torch.float64))
                    m[n].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                    v[n].mul_(opt["b2"]).add_((1 - opt["b2"]) * g.square())
                    p = params[n].detach()
                    step = (m[n] / b1c) / (torch.sqrt(v[n] / b2c)
                                           + opt["eps"]) \
                        + opt["weight_decay"] * p
                    p.sub_(lr * step)
            for n in names:
                params[n].requires_grad_(False)
    return losses, first


def _tree(flat: dict) -> dict:
    """{"/a/0/b": leaf} back into nested dicts and lists."""
    root: dict = {}
    for name, leaf in flat.items():
        keys = [int(s) if s.isdigit() else s for s in name.split("/")[1:]]
        node = root
        for key, nxt in zip(keys[:-1], keys[1:]):
            if isinstance(key, int):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
        node[keys[-1]] = leaf
    return root
