"""Plain PyTorch versions of the kernels (the correctness yardstick).

Twins of ``repro/kernels/ref.py``: each is the mathematical definition,
written for clarity, not speed; ``flash_attention_bwd_ref`` and
``ssm_scan_bwd_ref`` are the gradients of ``flash_attention_ref`` and
``ssm_scan_ref``, which the JAX package leaves to autodiff. The CPU tests
run them, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card. On the main path they run only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        scale=None):
    """q: (B, H, S, D), k: (B, Hk, S, D), v: (B, Hk, S, Dv) with H % Hk == 0
    -> (B, H, S, Dv). Full-matrix f32 softmax, finite ``-1e30`` mask,
    output cast to ``q.dtype``. Query head h reads kv head h // (H/Hk)."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    if h != hk:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def flash_attention_bwd_ref(q, k, v, out, dout, *, causal: bool = True,
                            window=None, scale=None):
    """The gradient of ``flash_attention_ref``, as explicit formulas in f32:
    P recomputed with the ``-1e30`` mask, ``dV = Pᵀ dO``,
    ``dS = P ∘ (dO Vᵀ − rowsum(dO ∘ O))``, ``dQ = dS K scale``,
    ``dK = dSᵀ Q scale``. ``out`` is the forward's output. Each kv head's
    dK and dV sum over its group of query heads. Returns (dq, dk, dv) in
    the dtypes of q, k and v."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    g = h // hk
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    p = torch.softmax(torch.where(mask, logits,
                                  torch.full_like(logits, NEG_INF)), dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(b, hk, g, s, d).sum(dim=2)
    dv = dv.reshape(b, hk, g, s, v.shape[-1]).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssm_scan_ref(decay, u, c, state0):
    """Selective-scan oracle (the Mamba recurrence), sequential over S.

    decay: (B, S, D, N) in [0, 1]; u: (B, S, D, N); c: (B, S, N);
    state0: (B, D, N). Computes in f32 and returns
    (y (B, S, D) f32, final state (B, D, N) f32):
      s_t = decay_t * s_{t-1} + u_t ;  y_t = sum_n s_t[:, :, n] * c_t[n]
    """
    s = state0.float()
    ys = []
    for t in range(decay.shape[1]):
        s = decay[:, t].float() * s + u[:, t].float()
        ys.append(torch.einsum("bdn,bn->bd", s, c[:, t].float()))
    return torch.stack(ys, dim=1), s


def ssm_scan_bwd_ref(decay, u, c, state0, dy, dfinal=None):
    """The gradient of ``ssm_scan_ref``, as a reverse scan of the state's
    adjoint in f32. dy: (B, S, D), the gradient of y; dfinal: (B, D, N),
    the final state's (None: zeros). With s_{-1} = state0:
      g_{S-1} = dy_{S-1} c_{S-1} + dfinal ;  g_t = dy_t c_t + decay_{t+1} g_{t+1}
      d_u_t = g_t ;  d_decay_t = g_t s_{t-1} ;  d_c_t[n] = sum_d dy_t[d] s_t[d, n]
      d_state0 = decay_0 g_0
    Returns (d_decay, d_u (B, S, D, N), d_c (B, S, N), d_state0 (B, D, N)),
    all f32."""
    s = state0.float()
    states = [s]  # s_{t-1} for t = 0 .. S
    for t in range(decay.shape[1]):
        s = decay[:, t].float() * s + u[:, t].float()
        states.append(s)
    g = torch.zeros_like(s) if dfinal is None else dfinal.float()
    d_decay = torch.empty(decay.shape, dtype=torch.float32,
                          device=decay.device)
    d_u = torch.empty_like(d_decay)
    d_c = torch.empty(c.shape, dtype=torch.float32, device=c.device)
    dyf, cf = dy.float(), c.float()
    for t in reversed(range(decay.shape[1])):
        g = g + dyf[:, t, :, None] * cf[:, t, None, :]
        d_u[:, t] = g
        d_decay[:, t] = g * states[t]
        d_c[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], states[t + 1])
        g = decay[:, t].float() * g
    return d_decay, d_u, d_c, g


def delta_mask_ref(new, old, block: int):
    """int8 changed-block bitmap of two equal 1-D arrays (1 = differs)."""
    n = new.shape[0] // block
    return (new.reshape(n, block) != old.reshape(n, block)).any(
        dim=1).to(torch.int8)


def delta_encode_ref(new, old, block: int):
    """Changed-block scan oracle.

    new, old: 1-D tensors, length divisible by ``block``.
    Returns (mask: (n_blocks,) bool -- block differs,
             packed: same shape as new -- changed blocks compacted to the
             front (stable order), zero-padded)."""
    n = new.shape[0] // block
    nb = new.reshape(n, block)
    mask = delta_mask_ref(new, old, block).bool()
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    packed = torch.where(mask[order][:, None], nb[order],
                         torch.zeros_like(nb[order]))
    return mask, packed.reshape(-1)
