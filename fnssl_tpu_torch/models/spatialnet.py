"""OnlineSpatialNet (IPDnet2), the Mamba flagship (port of
``fnssl_tpu/models/spatialnet.py`` with ``attention="mamba"``).

IPDnet2/IPDnet2.py:23-431:
  * causal conv encoder (k=5) over each frequency's time stream;
  * 8 SpatialNetLayers: per layer {LN→grouped freq Conv1d→PReLU} ×2, a
    full-band module (squeeze 1×1 conv+SiLU → Linear over frequency →
    unsqueeze+SiLU), and two Mamba blocks over time; layer 0 compresses
    frequency 256→128→16 (pools of 2 between the fconvs and of 8 after)
    and is followed by a 5× time mean;
  * FreqInverse decoder (a 1×1 conv expanding 16 bands → 256 bins, tanh)
    → Linear(16,16) → the reference's output reshape chain to (nb, nt/5,
    2·nf, nmic-1, 2 tracks), copied op for op.

Every Mamba block's recurrence runs ``models.mamba.SSMScan`` (K3 forward,
K4 backward); the convolutions are ``F.conv1d`` in full float32 on the
card, as the JAX package leaves them to XLA. The ``mhsa`` and ``ret`` time
modules (MHSA, T-ConvFFN, retention) are not ported yet.

State-dict names equal the JAX parameter paths (encoder.weight,
layers.0.fconv1.1.weight, layers.0.mhsa.A_log, freq_inverse.trans2.bias,
...), so converted weights load strictly.

Streaming: ``forward(x, state=..., return_state=True)`` carries the
encoder's conv tail and both Mamba states of every layer; chunks must be
multiples of the 5× time compression.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from fnssl_tpu_torch.models.layers import Conv1d, Linear
from fnssl_tpu_torch.models.mamba import (Mamba, MambaConfig, MambaState,
                                          init_mamba_state)
from fnssl_tpu_torch.utils.device import resolve_device


class MHSAConfig(NamedTuple):
    embed_dim: int
    num_heads: int
    attn_scope: int = 251     # 'mhsa(frames)' (IPDnet2.py:276)
    alibi: bool = False       # rope == 'ALiBi' (IPDnet2.py:372-377)


class TConvFFNConfig(NamedTuple):
    dim_hidden: int
    kernel_size: int = 3
    groups: int = 8
    factor: int = 2


class RetentionConfig(NamedTuple):
    embed_dim: int
    num_heads: int
    value_factor: int = 2
    share_qk: bool = False
    look_ahead: int = 0

    @property
    def value_dim(self):
        return self.embed_dim * self.value_factor

    @property
    def head_dim(self):
        return self.value_dim // self.num_heads

    @property
    def key_dim(self):
        return self.embed_dim // self.num_heads


class SpatialNetConfig(NamedTuple):
    dim_input: int = 10
    dim_output: int = 16
    num_layers: int = 8
    dim_squeeze: int = 8
    num_freqs: int = 256
    encoder_kernel_size: int = 5
    dim_hidden: int = 96
    d_state: int = 16
    mamba_conv: int = 4
    conv_groups: int = 8
    f_kernel_size: int = 5
    fre_compression_ratio: int = 16
    time_compression_ratio: int = 5
    time_compression_layer: int = 0
    # time-module selection (IPDnet2.py:276; 'mamba' uses d_state/mamba_conv
    # above unless given inline as 'mamba(d_state,d_conv)')
    attention: str = "mamba"
    num_heads: int = 4
    rope: bool | str = False          # retention rotary | 'ALiBi' for mhsa
    chunkwise_recurrent: bool = True
    recurrent_chunk_size: int = 20
    t_kernel_size: int = 3            # T-ConvFFN kernel (kernel_size[1])
    t_conv_groups: int = 8            # T-ConvFFN groups (conv_groups[1])
    tconvffn_factor: int = 2

    @property
    def time_kind(self) -> str:
        for kind in ("mamba", "mhsa", "ret"):
            if self.attention.startswith(kind):
                return kind
        raise ValueError(f"unknown attention {self.attention!r}")

    def _attn_args(self):
        a = self.attention
        if "(" not in a:
            return ()
        return tuple(int(v) for v in a[a.index("(") + 1:-1].split(","))

    @property
    def attn_scope(self) -> int:
        args = self._attn_args()
        return args[0] if args else 251          # 'mhsa(251)' default

    @property
    def ret_factor(self) -> int:
        args = self._attn_args()
        return args[0] if args else 2

    @property
    def mamba_cfg(self) -> MambaConfig:
        ds, dc = self.d_state, self.mamba_conv
        args = self._attn_args()
        if self.time_kind == "mamba" and len(args) == 2:
            ds, dc = args
        return MambaConfig(self.dim_hidden, ds, dc)

    @property
    def mhsa_cfg(self) -> MHSAConfig:
        return MHSAConfig(self.dim_hidden, self.num_heads, self.attn_scope,
                          alibi=self.rope == "ALiBi")

    @property
    def ret_cfg(self) -> RetentionConfig:
        return RetentionConfig(self.dim_hidden, self.num_heads,
                               self.ret_factor)

    @property
    def tconv_cfg(self) -> TConvFFNConfig:
        return TConvFFNConfig(self.dim_hidden, self.t_kernel_size,
                              self.t_conv_groups, self.tconvffn_factor)


class SpatialNetState(NamedTuple):
    encoder_tail: torch.Tensor  # (B·F, dim_input, k-1)
    time: tuple                 # ((MambaState, MambaState), ...) per layer


def init_spatialnet_state(nb: int, cfg: SpatialNetConfig = SpatialNetConfig(),
                          device=None) -> SpatialNetState:
    _check_kind(cfg)
    batch = nb * (cfg.num_freqs // cfg.fre_compression_ratio)
    return SpatialNetState(
        torch.zeros((nb * cfg.num_freqs, cfg.dim_input,
                     cfg.encoder_kernel_size - 1), device=device),
        tuple((init_mamba_state(batch, cfg.mamba_cfg, device),
               init_mamba_state(batch, cfg.mamba_cfg, device))
              for _ in range(cfg.num_layers)))


def _check_kind(cfg: SpatialNetConfig) -> None:
    if cfg.time_kind != "mamba":
        raise NotImplementedError(f"SpatialNet time module "
                                  f"{cfg.time_kind!r}: not ported yet")


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-5, weight ones, bias zeros."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones((dim,), device=device))
        self.bias = nn.Parameter(torch.zeros((dim,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.weight.to(x.dtype),
                            self.bias.to(x.dtype), 1e-5)


class _ChannelPReLU(nn.Module):
    """PReLU with one slope per channel (axis 1), initialised to 0.25."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((dim,), 0.25, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight[None, :, None] * x)


def _fconv_layers(cfg: SpatialNetConfig, device, generator) -> nn.ModuleDict:
    """{LN, grouped Conv1d over F, PReLU} as ModuleList indices 0, 1, 2."""
    h, k = cfg.dim_hidden, cfg.f_kernel_size
    return nn.ModuleDict({
        "0": LayerNorm(h, device=device),
        "1": Conv1d(h, h, k, groups=cfg.conv_groups,
                    padding=((k - 1) // 2, k // 2), device=device,
                    generator=generator),
        "2": _ChannelPReLU(h, device=device)})


def _fconv(p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, F, T, H) → LN(H) → grouped conv over F → PReLU
    (_fconv at IPDnet2.py:222-232)."""
    nb, f, t, h = x.shape
    y = p["0"](x).permute(0, 2, 3, 1).reshape(nb * t, h, f)
    y = p["2"](p["1"](y))
    return y.reshape(nb, t, h, f).permute(0, 3, 1, 2)


def _pool_freq(x: torch.Tensor, k: int) -> torch.Tensor:
    """Mean over groups of k frequencies; the last F % k are dropped."""
    nb, f, t, h = x.shape
    y = x.permute(0, 2, 3, 1)                        # (B, T, H, F)
    y = y[..., : f // k * k].reshape(nb, t, h, f // k, k).mean(-1)
    return y.permute(0, 3, 1, 2)


class SpatialNetLayer(nn.Module):
    """One OnlineSpatialNet layer with Mamba time modules; ``nfreq`` is the
    frequency count its full-band Linear sees."""

    def __init__(self, cfg: SpatialNetConfig, nfreq: int, *, device,
                 generator):
        super().__init__()
        h = cfg.dim_hidden
        kw = dict(device=device, generator=generator)
        self.fconv1 = _fconv_layers(cfg, device, generator)
        self.norm_full = LayerNorm(h, device=device)
        self.squeeze = nn.ModuleDict(
            {"0": Conv1d(h, cfg.dim_squeeze, 1, **kw)})
        self.full = Linear(nfreq, nfreq, **kw)
        self.unsqueeze = nn.ModuleDict(
            {"0": Conv1d(cfg.dim_squeeze, h, 1, **kw)})
        self.fconv2 = _fconv_layers(cfg, device, generator)
        self.norm_mhsa = LayerNorm(h, device=device)
        self.mhsa = Mamba(cfg.mamba_cfg, **kw)
        self.tconvffn = Mamba(cfg.mamba_cfg, **kw)
        self.norm_tconvffn = LayerNorm(h, device=device)

    def full_band(self, x: torch.Tensor) -> torch.Tensor:
        """Full-band module (IPDnet2.py:235-253). x: (B, F, T, H)."""
        nb, f, t, h = x.shape
        y = self.norm_full(x).permute(0, 2, 3, 1).reshape(nb * t, h, f)
        y = F.silu(self.squeeze["0"](y))
        y = self.full(y)                             # Linear over freq
        y = F.silu(self.unsqueeze["0"](y))
        return y.reshape(nb, t, h, f).permute(0, 3, 1, 2)


def _mamba_block(norm: LayerNorm, mamba: Mamba, x: torch.Tensor,
                 state: MambaState | None):
    nb, f, t, h = x.shape
    y = norm(x).reshape(nb * f, t, h)
    if state is None:
        y, new_state = mamba(y), None
    else:
        y, new_state = mamba(y, state)
    # the scan runs in float32; the residual stream keeps the compute
    # dtype (bf16 under the mixed-precision policy)
    return y.to(x.dtype).reshape(nb, f, t, h), new_state


class SpatialNet(nn.Module):
    """OnlineSpatialNet with Mamba time modules. ``device=None`` is the
    first CUDA device; weights are the JAX package's inits drawn from
    ``generator``."""

    def __init__(self, cfg: SpatialNetConfig = SpatialNetConfig(), *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        _check_kind(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        h = cfg.dim_hidden
        kw = dict(device=device, generator=generator)
        self.encoder = Conv1d(cfg.dim_input, h, cfg.encoder_kernel_size,
                              **kw)
        self.layers = nn.ModuleDict({
            str(i): SpatialNetLayer(
                cfg, cfg.num_freqs // 2 if i == 0
                else cfg.num_freqs // cfg.fre_compression_ratio, **kw)
            for i in range(cfg.num_layers)})
        self.freq_inverse = nn.ModuleDict({"trans2": Conv1d(
            h, cfg.fre_compression_ratio * cfg.dim_output, 1, **kw)})
        self.decoder = Linear(cfg.dim_output, cfg.dim_output, **kw)

    @property
    def device(self) -> torch.device:
        return self.encoder.weight.device

    def forward(self, x: torch.Tensor, state: SpatialNetState | None = None,
                return_state: bool = False,
                generator: torch.Generator | None = None):
        """Forward. x: (nb, dim_input, nf, nt), the run_IPDnet2 input layout.

        Returns (nb, nt/5, 2·nf, dim_output/4, 2), plus the new
        SpatialNetState when ``return_state``. With ``state``, x continues
        the previous chunk (nt a multiple of the time compression).
        ``generator`` is taken for the task interface; the model has no
        dropout.
        """
        cfg = self.cfg
        x = x.permute(0, 2, 3, 1)                    # (B, F, T, H0)
        nb, f, t, h0 = x.shape
        # encoder: causal conv over time per (batch, freq) stream
        yt = x.reshape(nb * f, t, h0).transpose(1, 2)  # (B·F, H0, T)
        k = cfg.encoder_kernel_size
        pad = (yt.new_zeros(yt.shape[:2] + (k - 1,)) if state is None
               else state.encoder_tail)
        dt = torch.promote_types(pad.dtype, yt.dtype)
        yin = torch.cat([pad.to(dt), yt.to(dt)], dim=-1)
        enc_tail = yin[..., -(k - 1):]
        y = self.encoder(yin).transpose(1, 2)        # (B·F, T, H)
        x = y.reshape(nb, f, t, cfg.dim_hidden)

        new_time = []
        for i in range(cfg.num_layers):
            layer = self.layers[str(i)]
            st = state.time[i] if state is not None else (None, None)
            x = x + _fconv(layer.fconv1, x)
            if i == 0:
                x = _pool_freq(x, 2)
            x = x + layer.full_band(x)
            x = x + _fconv(layer.fconv2, x)
            if i == 0:
                x = _pool_freq(x, cfg.fre_compression_ratio // 2)
            d1, s1 = _mamba_block(layer.norm_mhsa, layer.mhsa, x, st[0])
            x = x + d1
            d2, s2 = _mamba_block(layer.norm_tconvffn, layer.tconvffn, x,
                                  st[1])
            x = x + d2
            new_time.append((s1, s2))
            if i == cfg.time_compression_layer \
                    and cfg.time_compression_ratio > 1:
                nb_, f_, t_, h_ = x.shape
                r = cfg.time_compression_ratio
                x = x[:, :, : t_ // r * r].reshape(
                    nb_, f_, t_ // r, r, h_).mean(3)

        # FreqInverse decoder (IPDnet2.py:23-43)
        nb_, f16, t_, h = x.shape
        y = x.permute(0, 3, 2, 1)                    # (B, H, T, F16)
        w = self.freq_inverse["trans2"].weight[:, :, 0].to(y.dtype)
        b = self.freq_inverse["trans2"].bias.to(y.dtype)
        cr, out_dim = cfg.fre_compression_ratio, cfg.dim_output
        z = torch.einsum("bhtf,oh->botf", y, w) + b[None, :, None, None]
        z = z.reshape(nb_, out_dim, cr, t_, f16)
        # out[b, o, i·cr + j, t] = z[b, o, j, t, i]
        z = z.permute(0, 1, 4, 2, 3).reshape(nb_, out_dim, f16 * cr, t_)
        z = torch.tanh(z.permute(0, 1, 3, 2))        # (B, out, T, F)
        z = self.decoder(z.permute(0, 3, 2, 1))      # (B, F, T, out)

        # output reshape chain (IPDnet2.py:360-364)
        bsz, f_, t2, _ = z.shape
        z = z.permute(0, 2, 1, 3).reshape(bsz, t2, f_, 2, -1)
        z = z.permute(0, 1, 3, 2, 4)
        z = z.reshape(bsz, t2, 2, f_ * 2, -1)
        out = z.permute(0, 1, 3, 4, 2)
        if return_state:
            return out, SpatialNetState(enc_tail, tuple(new_time))
        return out
