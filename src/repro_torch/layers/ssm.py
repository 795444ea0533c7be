"""Mamba2 SSD (state-space duality) mixer: the chunked parallel form for
a full sequence and the recurrent single-token decode step (the
reference's ``repro.layers.ssm``).

Precision follows the reference's default path: the decay and cumsum
math is f32, the large intra-chunk tensors stay in the input dtype, and
every product the reference asks for with ``preferred_element_type=f32``
takes f32 operands here and returns f32 (a bf16 ``torch.einsum`` would
round its output to bf16). The depthwise conv and the decode state are
f32. ``softplus`` is JAX's ``logaddexp(x, 0)``: torch's ``F.softplus``
switches to x above 20, which rounds differently.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.layers.norms import pad_lanes, rms_norm
from repro_torch.sharding import specs

Params = Dict[str, torch.Tensor]
f32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as ``jax.nn.softplus`` computes it: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Segment sums: out[..., i, j] = Σ_{k=j+1..i} x[..., k]; −inf above
    the diagonal."""
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    q = x.shape[-1]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, -torch.inf)


def ssd_chunked(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD dual-form scan.

    x [b, t, h, p] (already multiplied by dt), dA [b, t, h] (dt·A,
    negative), B, C [b, t, n] (one group shared across heads); t a
    multiple of ``chunk``. Returns (y [b, t, h, p] in x's dtype, the f32
    final state [b, h, p, n]).
    """
    b, t, h, p = x.shape
    n = B.shape[-1]
    assert t % chunk == 0, (t, chunk)
    c = t // chunk
    cdt = x.dtype

    xb = x.reshape(b, c, chunk, h, p).to(f32)
    Bb = B.reshape(b, c, chunk, n).to(cdt).to(f32)
    Cb = C.reshape(b, c, chunk, n).to(cdt).to(f32)
    Ab = dA.reshape(b, c, chunk, h).permute(0, 3, 1, 2).to(f32)
    A_cumsum = torch.cumsum(Ab, dim=-1)                    # [b,h,c,q]

    # 1. intra-chunk (diagonal blocks): (C·Bᵀ) ∘ L, then times x
    L = torch.exp(segsum(Ab)).to(cdt).to(f32)              # [b,h,c,l,s]
    CB = torch.einsum("bcln,bcsn->bcls", Cb, Bb)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * L, xb)

    # 2. per-chunk output states
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum).to(cdt).to(f32)
    states = torch.einsum("bcln,bclhp->bchpn", Bb,
                          xb * decay_states.permute(0, 2, 3, 1)[..., None])

    # 3. inter-chunk recurrence over chunk states
    if initial_state is None:
        init = torch.zeros((b, 1, h, p, n), dtype=f32, device=x.device)
    else:
        init = initial_state.to(f32)[:, None]
    states = torch.cat([init, states], dim=1)              # [b,c+1,h,p,n]
    chunk_decay = A_cumsum[..., -1]                        # [b,h,c]
    padded = F.pad(chunk_decay, (1, 0))
    decay_chunk = torch.exp(segsum(padded))                # [b,h,c+1,c+1]
    decay_chunk = torch.where(torch.isfinite(decay_chunk), decay_chunk, 0.0)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output contribution
    state_decay_out = torch.exp(A_cumsum).to(cdt).to(f32)  # [b,h,c,q]
    Y_off = torch.einsum("bcln,bchpn->bclhp", Cb,
                         prev_states.to(cdt).to(f32)) \
        * state_decay_out.permute(0, 2, 3, 1)[..., None]

    y = (Y_diag + Y_off).reshape(b, t, h, p)
    return y.to(x.dtype), final_state


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in f32: x [B, T, C], w [W, C], b [C];
    out[t] = Σ_k x[t − W + 1 + k]·w[k] (zeros before the start)."""
    width, T = w.shape[0], x.shape[1]
    xp = F.pad(x.to(f32), (0, 0, width - 1, 0))
    w = w.to(f32)
    out = xp[:, 0:T] * w[0]
    for k in range(1, width):
        out = out + xp[:, k:k + T] * w[k]
    return (out + b.to(f32)).to(x.dtype)


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, n_state: int,
                n_heads: int):
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * n_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * n_state:]
    return z, xBC, dt


def mamba2_forward(params: Params, x_in: torch.Tensor, *, d_inner: int,
                   n_state: int, n_heads: int, head_dim: int, chunk: int,
                   norm_eps: float = 1e-5,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 mixer -> (out [B, T, D], the f32 final SSM
    state [B, h, p, n], the conv tail [B, W, C]: the last ``conv_width``
    pre-conv xBC rows, zeros ahead of a short sequence, which
    ``mamba2_decode`` takes as its conv state after a prefill). DTensors
    run on each rank's batch shard (the mixer's weights replicate)."""
    if specs.is_dtensor(x_in):
        return specs.local_rows(
            lambda p, x, s0: mamba2_forward(
                p, x, d_inner=d_inner, n_state=n_state, n_heads=n_heads,
                head_dim=head_dim, chunk=chunk, norm_eps=norm_eps,
                initial_state=s0), params, x_in, initial_state)
    B_, T, _ = x_in.shape
    zxbcdt = x_in @ params["w_in"]
    z, xBC, dt = _split_proj(zxbcdt, d_inner, n_state, n_heads)

    width = params["conv_w"].shape[0]
    conv_tail = F.pad(xBC, (0, 0, width, 0))[:, -width:, :]

    xBC = F.silu(causal_conv(xBC, params["conv_w"], params["conv_b"]))
    x_part = xBC[..., :d_inner]
    Bmat = xBC[..., d_inner:d_inner + n_state]
    Cmat = xBC[..., d_inner + n_state:]

    dt = softplus(dt.to(f32) + params["dt_bias"].to(f32))
    A = -torch.exp(params["A_log"].to(f32))                  # [nh]

    pad = (-T) % chunk
    xh = x_part.reshape(B_, T, n_heads, head_dim)
    xdt = xh * dt[..., None].to(xh.dtype)
    dA = dt * A
    if pad:
        # dA = 0 on the padding: decay 1 and no input, so the final state
        # is the state after the last real token
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    y, final_state = ssd_chunked(xdt, dA, Bmat, Cmat, chunk,
                                 initial_state=initial_state)
    y = y[:, :T]
    y = y + params["Dp"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B_, T, d_inner)
    y = rms_norm(y * F.silu(z), params["ssm_norm"], norm_eps)
    return y @ params["w_out"], final_state, conv_tail


def mamba2_decode(params: Params, x_in: torch.Tensor,
                  ssm_state: torch.Tensor, conv_state: torch.Tensor, *,
                  d_inner: int, n_state: int, n_heads: int, head_dim: int,
                  norm_eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step: x_in [B, 1, D], ssm_state
    [B, h, p, n], conv_state [B, W, C] -> (out [B, 1, D], the f32
    ssm_state', conv_state' in its own dtype). The inputs are left as
    they were. Its products run on the lanes padded to
    ``norms.DECODE_ROWS``, so a lane's result is the same at every lane
    width up to it. DTensors run on each rank's batch shard."""
    if specs.is_dtensor(x_in):
        return specs.local_rows(functools.partial(
            mamba2_decode, d_inner=d_inner, n_state=n_state,
            n_heads=n_heads, head_dim=head_dim, norm_eps=norm_eps),
            params, x_in, ssm_state, conv_state)
    B_ = x_in.shape[0]
    zxbcdt = (pad_lanes(x_in) @ params["w_in"])[:B_, 0]
    z, xBC, dt = _split_proj(zxbcdt, d_inner, n_state, n_heads)

    conv_state = torch.cat([conv_state[:, 1:],
                            xBC[:, None, :].to(conv_state.dtype)], dim=1)
    w = params["conv_w"].to(f32)                             # [W, C]
    xBC = torch.sum(conv_state.to(f32) * w, dim=1)
    xBC = F.silu(xBC + params["conv_b"].to(f32)).to(x_in.dtype)
    x_part = xBC[..., :d_inner]
    Bmat = xBC[..., d_inner:d_inner + n_state].to(f32)
    Cmat = xBC[..., d_inner + n_state:].to(f32)

    dt = softplus(dt.to(f32) + params["dt_bias"].to(f32))    # [B, nh]
    A = -torch.exp(params["A_log"].to(f32))
    dA = torch.exp(dt * A)

    xh = x_part.reshape(B_, n_heads, head_dim).to(f32)
    ssm_state = (dA[:, :, None, None] * ssm_state.to(f32)
                 + dt[:, :, None, None] * xh[..., None]
                 * Bmat[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", pad_lanes(ssm_state),
                     pad_lanes(Cmat))[:B_]
    y = y + params["Dp"].to(f32)[None, :, None] * xh
    y = y.reshape(B_, d_inner).to(x_in.dtype)
    y = rms_norm(y * F.silu(z), params["ssm_norm"], norm_eps)
    return ((pad_lanes(y) @ params["w_out"])[:B_, None, :], ssm_state,
            conv_state)
