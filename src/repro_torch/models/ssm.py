"""State-space mixers: Mamba (Jamba's).

Port of the Mamba half of ``repro/models/ssm.py``. Prefill computes the
per-position decays and inputs in f32 and runs the recurrence through
``kernels.ops.ssm_scan`` (the CUDA kernel on the card, its plain version on
the CPU), where the JAX package runs a chunked associative scan in jnp: the
kernel is sequential over S, so one launch covers the whole sequence from a
zero state. Decode is a single-step state update in plain PyTorch, as in
the JAX package. RWKV is not ported yet (ROADMAP, Queue 1).

Numerics: decays and states are f32; every decay is exp(negative) <= 1.
The conv and SSM caches are updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import normal_init


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
    dbc = xc @ params["x_proj"]
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


def mamba_forward(params: dict, x: torch.Tensor, spec: MambaSpec,
                  d_model: int, *, cache: Optional[dict] = None):
    """Prefill. x: (B,S,d). Returns (out, cache|None); a given cache gets
    the last K-1 conv inputs and the final SSM state in place."""
    xz = x @ params["in_proj"]
    xu, z = xz.chunk(2, dim=-1)
    xc = F.silu(_causal_depthwise_conv(xu, params["conv_w"],
                                       params["conv_b"]).float()).to(x.dtype)
    decay_log, u, cmat = _mamba_ssm_params(params, xc, spec, d_model)
    decay = decay_log.exp_()  # in place: decay_log is not needed again
    state0 = torch.zeros((x.shape[0], spec.d_inner(d_model), spec.d_state),
                         dtype=torch.float32, device=x.device)
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
