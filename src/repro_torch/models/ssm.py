"""State-space mixers: Mamba (Jamba's) and RWKV6 (Finch).

Port of ``repro/models/ssm.py``. Mamba's train and prefill
compute the per-position decays and inputs in f32 and run the recurrence
through ``kernels.ops.ssm_scan`` (the CUDA kernel on the card, its plain
version on the CPU), where the JAX package runs a chunked associative scan
in jnp: the kernel is sequential over S, so one launch covers the whole
sequence from a zero state. In training its gradient is the ``ssm_scan``
backward kernel (the plain reverse scan on the CPU), where the JAX package
differentiates its scan; the rest of the layer's gradient is autograd's.
Decode is a single-step state update in plain PyTorch, as in the JAX
package.

RWKV6's time mix runs its wkv recurrence chunk by chunk in plain PyTorch
(``_rwkv_chunk``), as the JAX package does in jnp: within a chunk the
pairwise decays, between chunks the carried (B, H, dk, dv) state, with the
same chunk boundaries. Prefill always shifts in zeros at position 0; only
decode reads the cached shifts, as in the reference.

Numerics: decays and states are f32; every decay is exp(negative) <= 1.
The conv, SSM, shift and wkv caches are updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import MambaSpec, RWKVSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import normal_init, reduce_partial, reshape


def init_mamba(gen: torch.Generator, d_model: int, spec: MambaSpec, dtype,
               device, lead=()) -> dict:
    di = spec.d_inner(d_model)
    r = spec.resolved_dt_rank(d_model)
    a_log = torch.log(torch.arange(1, spec.d_state + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": normal_init(gen, (*lead, d_model, 2 * di), dtype, device),
        "conv_w": normal_init(gen, (*lead, spec.d_conv, di), dtype, device,
                              std=0.1),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=device),
        "x_proj": normal_init(gen, (*lead, di, r + 2 * spec.d_state), dtype,
                              device),
        "dt_proj": normal_init(gen, (*lead, r, di), dtype, device,
                               std=r ** -0.5),
        "dt_bias": torch.full((*lead, di), -4.6, dtype=dtype,
                              device=device),  # softplus^-1(0.01)
        "A_log": a_log.expand(*lead, di, spec.d_state).contiguous(),
        "D": torch.ones((*lead, di), dtype=torch.float32, device=device),
    }


def init_mamba_full(gen: torch.Generator, d_model: int, spec: MambaSpec,
                    dtype, device, lead=()) -> dict:
    p = init_mamba(gen, d_model, spec, dtype, device, lead)
    p["out_proj"] = normal_init(gen, (*lead, spec.d_inner(d_model), d_model),
                                dtype, device)
    return p


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: (B,S,di), w: (K,di) causal depthwise conv, in f32. Written as K
    shifted multiply-adds rather than ``F.conv1d``, which cuDNN would run
    in TF32 on the card by default."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))  # k-1 zero positions in front
    wf = w.float()
    out = xp[:, :s] * wf[0]
    for j in range(1, k):
        out = out + xp[:, j:j + s] * wf[j]
    return (out + b.float()).to(x.dtype)


def _mamba_ssm_params(params, xc, spec: MambaSpec, d_model: int):
    """xc: (B,S,di) post-conv. Returns decay_log, u, C, all f32."""
    r = spec.resolved_dt_rank(d_model)
    # over a mesh, the TP-sharded contraction's partial sums are summed
    # here, on (B,S,r+2N), not on the (B,S,di,N) scan inputs
    dbc = reduce_partial(xc @ params["x_proj"])
    dt, bmat, cmat = torch.split(dbc, [r, spec.d_state, spec.d_state],
                                 dim=-1)
    dt = F.softplus((dt @ params["dt_proj"]).float()
                    + params["dt_bias"].float())  # (B,S,di)
    a = -torch.exp(params["A_log"])  # (di, ds)
    decay_log = dt[..., None] * a  # (B,S,di,ds) <= 0
    u = (dt * xc.float())[..., None] * bmat.float()[:, :, None, :]
    return decay_log, u, cmat.float()


def _gate_out(params, y, xc, z, x_dtype):
    y = y + params["D"] * xc.float()
    y = (y * F.silu(z.float())).to(x_dtype)
    return y @ params["out_proj"]


def _scan_layout(decay, u, cmat, state_shape):
    """The scan's DTensor inputs laid out as the kernel takes them, shard by
    shard: decay and u sharded over batch or D only (anything else
    gathered), c over the batch alone, and a zero state0 to match."""
    mesh = decay.device_mesh
    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in decay.placements)
    c_pl, s_pl, _ = ops.ssm_scan_placements(pl)
    local = list(state_shape)
    for i, p in enumerate(s_pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.shape[i]
    state0 = ops.wrap_local(torch.zeros(local, dtype=torch.float32,
                                        device=decay.to_local().device),
                            mesh, s_pl)
    return (decay.redistribute(mesh, pl), u.redistribute(mesh, pl),
            cmat.redistribute(mesh, c_pl), state0)


def mamba_forward(params: dict, x: torch.Tensor, spec: MambaSpec,
                  d_model: int, *, cache: Optional[dict] = None):
    """Prefill. x: (B,S,d). Returns (out, cache|None); a given cache gets
    the last K-1 conv inputs and the final SSM state in place."""
    xz = x @ params["in_proj"]
    xu, z = xz.chunk(2, dim=-1)
    xc = F.silu(_causal_depthwise_conv(xu, params["conv_w"],
                                       params["conv_b"]).float()).to(x.dtype)
    decay_log, u, cmat = _mamba_ssm_params(params, xc, spec, d_model)
    # in place, in training too: decay_log is not needed again, and
    # autograd's exp saves its result, the decay the scan keeps anyway
    decay = decay_log.exp_()
    state0 = torch.zeros((x.shape[0], spec.d_inner(d_model), spec.d_state),
                         dtype=torch.float32, device=x.device)
    if isinstance(decay, DTensor):
        decay, u, cmat, state0 = _scan_layout(decay, u, cmat, state0.shape)
    y, state = ops.ssm_scan(decay, u, cmat.contiguous(), state0)
    del decay_log, decay, u  # (B,S,di,ds) f32: free before the projection
    out = _gate_out(params, y, xc, z, x.dtype)
    if cache is not None:
        k = spec.d_conv - 1
        cache["conv"].copy_(xu[:, -k:])
        cache["ssm"].copy_(state)
    return out, cache


def mamba_decode(params: dict, x: torch.Tensor, spec: MambaSpec,
                 d_model: int, *, cache: dict):
    """x: (B,1,d). cache: conv (B,K-1,di), ssm (B,di,ds), updated in
    place."""
    xz = x @ params["in_proj"]
    xu, z = xz.chunk(2, dim=-1)  # (B,1,di)
    window = torch.cat([cache["conv"].to(xu.dtype), xu], dim=1)
    conv = torch.einsum("bkd,kd->bd", window.float(),
                        params["conv_w"].float())
    xc = F.silu(conv + params["conv_b"].float())[:, None].to(x.dtype)
    decay_log, u, cmat = _mamba_ssm_params(params, xc, spec, d_model)
    state = torch.exp(decay_log[:, 0]) * cache["ssm"] + u[:, 0]
    y = torch.einsum("bds,bs->bd", state, cmat[:, 0])[:, None]
    out = _gate_out(params, y, xc, z, x.dtype)
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(state)
    return out, cache


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================


def init_rwkv(gen: torch.Generator, d_model: int, spec: RWKVSpec, dtype,
              device, lead=()) -> dict:
    """``w0`` and ``bonus_u`` are f32 whatever ``dtype``, as in the JAX
    package."""
    h = d_model // spec.head_dim

    def w(shape, std=0.02, dt=dtype):
        return normal_init(gen, (*lead, *shape), dt, device, std=std)
    return {
        "mix_mu": w((5, d_model), 0.1),
        "mix_x": w((d_model,), 0.1),
        "mix_w1": w((d_model, 5 * spec.mix_lora)),
        "mix_w2": w((5, spec.mix_lora, d_model)),
        "wr": w((d_model, d_model)),
        "wk": w((d_model, d_model)),
        "wv": w((d_model, d_model)),
        "wg": w((d_model, d_model)),
        "wo": w((d_model, d_model)),
        "w0": torch.full((*lead, d_model), -1.0, dtype=torch.float32,
                         device=device),
        "dw1": w((d_model, spec.decay_lora)),
        "dw2": w((spec.decay_lora, d_model)),
        "bonus_u": w((h, spec.head_dim), 0.5, torch.float32),
        "ln_x_scale": torch.ones((*lead, d_model), dtype=dtype,
                                 device=device),
        "ln_x_bias": torch.zeros((*lead, d_model), dtype=dtype,
                                 device=device),
    }


def init_rwkv_channel(gen: torch.Generator, d_model: int, spec: RWKVSpec,
                      dtype, device, lead=()) -> dict:
    def w(shape, std=0.02):
        return normal_init(gen, (*lead, *shape), dtype, device, std=std)
    return {"cmu_k": w((d_model,), 0.1), "cmu_r": w((d_model,), 0.1),
            "ck": w((d_model, spec.d_ffn)), "cv": w((spec.d_ffn, d_model)),
            "cr": w((d_model, d_model))}


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """Shift right by one along S; position 0 sees ``prev`` (or zeros)."""
    b, s, d = x.shape
    first = x.new_zeros((b, 1, d)) if prev is None else \
        prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1) if s > 1 else first


def _ddlerp(params, x, xx):
    """Data-dependent lerp producing the 5 mixed inputs (r, k, v, g, w)."""
    dx = (xx - x).float()
    xf = x.float()
    base = xf + dx * params["mix_x"].float()
    lora = torch.tanh(base.to(x.dtype) @ params["mix_w1"])  # (B,S,5*ml)
    b, s, _ = x.shape
    lora = reshape(lora, b, s, 5, -1)
    dyn = torch.einsum("bsfm,fmd->bsfd", lora, params["mix_w2"])
    mix = params["mix_mu"].float() + dyn.float()  # (B,S,5,d)
    out = xf[:, :, None, :] + dx[:, :, None, :] * mix
    return [out[:, :, i].to(x.dtype) for i in range(5)]


def _rwkv_proj(params, xs, h, dh):
    xr, xk, xv, xg, xw = xs
    b, s, _ = xr.shape
    r = reshape(xr @ params["wr"], b, s, h, dh)
    k = reshape(xk @ params["wk"], b, s, h, dh)
    v = reshape(xv @ params["wv"], b, s, h, dh)
    g = F.silu((xg @ params["wg"]).float())
    logw = -torch.exp(params["w0"].float()
                      + (torch.tanh(xw @ params["dw1"])
                         @ params["dw2"]).float())
    logw = reshape(torch.clamp(logw, -20.0, -1e-5), b, s, h, dh)
    return r, k, v, g, logw


def _rwkv_chunk(r, k, v, logw, u, state0):
    """One wkv chunk. r/k/v/logw: (B,L,H,dk|dv), state0: (B,H,dk,dv) f32.
    Returns (y (B,L,H,dv) f32, the state after the chunk). The running sum
    of the log decays is a product with a triangle of ones: ``cumsum`` on
    the card has no deterministic kernel, which training needs."""
    rf, kf, vf = r.float(), k.float(), v.float()
    n = r.shape[1]
    ones = torch.ones((n, n), dtype=torch.float32, device=r.device)
    lwc = torch.einsum("ts,bshd->bthd", torch.tril(ones), logw)  # inclusive
    ex = lwc - logw  # exclusive
    # inter-chunk: r_t . (exp(ex_t) * S0)
    y_inter = torch.einsum("blhd,bhdv->blhv", rf * torch.exp(ex), state0)
    # intra-chunk pairwise decays (strictly s < t): exp(ex_t - lwc_s) <= 1
    diff = ex[:, :, None] - lwc[:, None, :]  # (B,Lt,Ls,H,dk)
    tri = torch.tril(ones, diagonal=-1)
    pair = torch.exp(torch.clamp(diff, max=0.0)) * tri[None, :, :, None, None]
    amat = (rf[:, :, None] * kf[:, None] * pair).sum(-1)  # (B,Lt,Ls,H)
    diag = (rf * u * kf).sum(-1)  # (B,L,H): the bonus on s = t
    y_intra = torch.einsum("btsh,bshv->bthv", amat, vf) + diag[..., None] * vf
    # new state: exp(lwc_L)*S0 + sum_s exp(lwc_L - lwc_s) k_s (x) v_s
    w_all = torch.exp(lwc[:, -1])  # (B,H,dk)
    k_dec = kf * torch.exp(lwc[:, -1][:, None] - lwc)
    s_new = w_all[..., None] * state0 + torch.einsum("bshd,bshv->bhdv",
                                                      k_dec, vf)
    return y_inter + y_intra, s_new


def rwkv_time_mix(params: dict, x: torch.Tensor, spec: RWKVSpec, *,
                  chunk: int = 64, cache: Optional[dict] = None,
                  mode: str = "train"):
    """Returns (out, cache|None). cache: shift_tm (B,d), wkv (B,H,dk,dv)
    f32, updated in place. Prefill and train shift in zeros and start from
    ``cache["wkv"]`` (zeros without a cache); decode reads both."""
    b, s, d = x.shape
    h, dh = d // spec.head_dim, spec.head_dim
    if mode == "decode":
        xx = cache["shift_tm"][:, None].to(x.dtype)
    else:
        xx = _token_shift(x, None)
    r, k, v, g, logw = _rwkv_proj(params, _ddlerp(params, x, xx), h, dh)
    u = params["bonus_u"]

    if mode == "decode":
        state0 = cache["wkv"]
        kf, vf, rf = k.float()[:, 0], v.float()[:, 0], r.float()[:, 0]
        kv = kf[..., None] * vf[..., None, :]  # (B,H,dk,dv)
        # the output reads the state before this step's update
        y = torch.einsum("bhd,bhdv->bhv", rf, state0 + u[..., None] * kv)
        state = torch.exp(logw[:, 0])[..., None] * state0 + kv
        y = y[:, None]  # (B,1,H,dv)
    else:
        n = min(chunk, s)
        pad = (-s) % n
        if pad:  # a padded step: k = 0 and logw = 0 keep the state as is
            r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                             for t in (r, k, v, logw))
        state = cache["wkv"] if cache is not None else torch.zeros(
            (b, h, dh, dh), dtype=torch.float32, device=x.device)
        ys = []
        for c in range(0, s + pad, n):  # the JAX package's lax.scan
            y_c, state = _rwkv_chunk(r[:, c:c + n], k[:, c:c + n],
                                     v[:, c:c + n], logw[:, c:c + n], u,
                                     state)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)[:, :s]
    if cache is not None:
        cache["shift_tm"].copy_(x[:, -1])
        cache["wkv"].copy_(state)

    # per-head group norm (population variance), then gate and project
    yf = reshape(y, b, -1, h, dh)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yn = (yf - mu) * torch.rsqrt(var + 1e-5)
    yn = reshape(yn, b, -1, d) * params["ln_x_scale"].float() \
        + params["ln_x_bias"].float()
    return (yn * g).to(x.dtype) @ params["wo"], cache


def rwkv_channel_mix(params: dict, x: torch.Tensor, *,
                     cache: Optional[dict] = None, mode: str = "train"):
    """RWKV6 channel mix. cache: shift_cm (B,d), updated in place."""
    if mode == "decode":
        xx = cache["shift_cm"][:, None].to(x.dtype)
    else:
        xx = _token_shift(x, None)
    dx = xx - x
    xk = x + dx * params["cmu_k"]
    xr = x + dx * params["cmu_r"]
    kk = torch.square(F.relu((xk @ params["ck"]).float()))
    vv = kk.to(x.dtype) @ params["cv"]
    rr = torch.sigmoid((xr @ params["cr"]).float())
    out = (rr * vv.float()).to(x.dtype)
    if cache is not None:
        cache["shift_cm"].copy_(x[:, -1])
    return out, cache
