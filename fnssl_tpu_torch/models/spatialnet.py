"""OnlineSpatialNet (IPDnet2) with selectable time modules (port of
``fnssl_tpu/models/spatialnet.py``).

IPDnet2/IPDnet2.py:23-431:
  * causal conv encoder (k=5) over each frequency's time stream;
  * 8 SpatialNetLayers: per layer {LN→grouped freq Conv1d→PReLU} ×2, a
    full-band module (squeeze 1×1 conv+SiLU → Linear over frequency →
    unsqueeze+SiLU), and two time modules; layer 0 compresses
    frequency 256→128→16 (pools of 2 between the fconvs and of 8 after)
    and is followed by a 5× time mean;
  * FreqInverse decoder (a 1×1 conv expanding 16 bands → 256 bins, tanh)
    → Linear(16,16) → the reference's output reshape chain to (nb, nt/5,
    2·nf, nmic-1, 2 tracks), copied op for op.

Time modules, as the reference's ``attention=`` string selects them
(IPDnet2.py:276; the flagship 'mamba(16,4)', run_IPDnet2.py:114):
  * ``mamba(d_state,d_conv)``: both are Mamba blocks, whose recurrence
    runs ``models.mamba.SSMScan`` (K3 forward, K4 backward);
  * ``mhsa(scope)``: MHSA with ``get_causal_mask``'s bounded look-back of
    ``scope`` frames (ALiBi when ``rope='ALiBi'``), then T-ConvFFN;
  * ``ret(factor)``: multi-scale retention (chunkwise or parallel one-shot
    mode by ``chunkwise_recurrent``, per-frame recurrent when streaming),
    then T-ConvFFN.
MHSA and retention are plain matrix products and launch no kernel of the
port. The convolutions are ``F.conv1d`` in full float32 on the card, as
the JAX package leaves them to XLA.

State-dict names equal the JAX parameter paths (encoder.weight,
layers.0.fconv1.1.weight, layers.0.mhsa.A_log, freq_inverse.trans2.bias,
...), so converted weights load strictly.

Frequency parallelism: ``forward(x, freq_mesh=mesh)`` takes this rank's
bins of a 2-D (data × freq) mesh (``parallel.make_mesh_2d``) and crosses
frequency through ``parallel/freq.py`` where the JAX package leaves it to
XLA's partitioner: the grouped frequency convs take a halo, the full-band
Linear and the output gather the whole axis, and from the first pool
whose windows straddle shards the net runs replicated on every freq rank.
The encoder, the time modules and the FreqInverse decoder are per bin or
band and run on the shard.

Streaming: ``forward(x, state=..., return_state=True)`` carries the
encoder's conv tail and every time module's state (Mamba's conv tail and
SSM state, MHSA's bounded input window, retention's rescaled kv state,
T-ConvFFN's conv tail); chunks must be multiples of the 5× time
compression.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from fnssl_tpu_torch.models.attention import (
    MHSA, MHSAConfig, TConvFFN, TConvFFNConfig, causal_mask, init_mhsa_state,
    init_tconvffn_state)
from fnssl_tpu_torch.models.layers import (Conv1d, LayerNorm, Linear,
                                           conv1d, linear)
from fnssl_tpu_torch.models.mamba import (Mamba, MambaConfig, MambaState,
                                          init_mamba_state)
from fnssl_tpu_torch.models.retention import (
    Retention, RetentionConfig, RetNetRelPos, retention_chunkwise,
    retention_parallel, retention_recurrent_step)
from fnssl_tpu_torch.parallel.freq import FreqShard
from fnssl_tpu_torch.utils.device import resolve_device


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


class RetentionState(NamedTuple):
    kv: torch.Tensor     # (B·F, heads, key_dim, head_dim) rescaled kv
    scale: torch.Tensor  # (heads,) or (B·F, heads) running scale
    pos: torch.Tensor    # () or (B·F,) int32 absolute frame index (rotary)


class SpatialNetState(NamedTuple):
    encoder_tail: torch.Tensor  # (B·F, dim_input, k-1)
    time: tuple                 # ((mod1_state, mod2_state), ...) per layer


def init_spatialnet_state(nb: int, cfg: SpatialNetConfig = SpatialNetConfig(),
                          device=None, per_row: bool = False
                          ) -> SpatialNetState:
    """The streaming state of ``nb`` streams. JAX's leaves by default:
    MHSA's and retention's positions and retention's running scale are
    shared by the batch. ``per_row`` gives them one value a row of the
    B·F time-module batch, so that every leaf grows with nb and streams
    at different positions can share a batch (the slot pool's)."""
    batch = nb * (cfg.num_freqs // cfg.fre_compression_ratio)
    kind, rc = cfg.time_kind, cfg.ret_cfg
    rows = (batch,) if per_row else ()
    states = []
    for _ in range(cfg.num_layers):
        if kind == "mamba":
            states.append((init_mamba_state(batch, cfg.mamba_cfg, device),
                           init_mamba_state(batch, cfg.mamba_cfg, device)))
            continue
        if kind == "mhsa":
            s1 = init_mhsa_state(batch, cfg.mhsa_cfg, device, per_row)
        else:
            s1 = RetentionState(
                torch.zeros((batch, rc.num_heads, rc.key_dim, rc.head_dim),
                            device=device),
                torch.zeros(rows + (rc.num_heads,), device=device),
                torch.zeros(rows, dtype=torch.int32, device=device))
        states.append((s1, init_tconvffn_state(batch, cfg.tconv_cfg,
                                               device)))
    return SpatialNetState(
        torch.zeros((nb * cfg.num_freqs, cfg.dim_input,
                     cfg.encoder_kernel_size - 1), device=device),
        tuple(states))


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


def _fconv(p: nn.ModuleDict, x: torch.Tensor,
           fx: FreqShard | None = None) -> torch.Tensor:
    """x: (B, F, T, H) → LN(H) → grouped conv over F → PReLU
    (_fconv at IPDnet2.py:222-232). On a shard of F the conv's padding is
    the neighbours' bins (zeros at the global edges)."""
    nb, f, t, h = x.shape
    y = p["0"](x).permute(0, 2, 3, 1).reshape(nb * t, h, f)
    conv = p["1"]
    if fx is None:
        y = conv(y)
    else:
        y = conv1d(fx.halo(y, *conv.padding), conv.weight, conv.bias,
                   conv.groups)
    y = p["2"](y)
    return y.reshape(nb, t, h, f).permute(0, 3, 1, 2)


def _pool_freq(x: torch.Tensor, k: int, fx: FreqShard | None = None):
    """Mean over groups of k frequencies; the last F % k are dropped.
    Returns (pooled, fx): on a shard whose bins the windows do not tile,
    the shards are gathered first and fx becomes None (the rest runs
    replicated)."""
    if fx is not None and x.shape[1] % k:
        x, fx = fx.gather(x, 1), None
    nb, f, t, h = x.shape
    y = x.permute(0, 2, 3, 1)                        # (B, T, H, F)
    y = y[..., : f // k * k].reshape(nb, t, h, f // k, k).mean(-1)
    return y.permute(0, 3, 1, 2), fx


class SpatialNetLayer(nn.Module):
    """One OnlineSpatialNet layer; ``nfreq`` is the frequency count its
    full-band Linear sees. The time modules sit under the reference's
    names ``mhsa`` and ``tconvffn`` whatever their kind; ``norm_tconvffn``
    exists for Mamba only (T-ConvFFN carries its LN as element 0)."""

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
        kind = cfg.time_kind
        if kind == "mamba":
            self.mhsa = Mamba(cfg.mamba_cfg, **kw)
            self.tconvffn = Mamba(cfg.mamba_cfg, **kw)
            self.norm_tconvffn = LayerNorm(h, device=device)
        else:
            self.mhsa = (MHSA(cfg.mhsa_cfg, **kw) if kind == "mhsa"
                         else Retention(cfg.ret_cfg, **kw))
            self.tconvffn = TConvFFN(cfg.tconv_cfg, **kw)

    def full_band(self, x: torch.Tensor,
                  fx: FreqShard | None = None) -> torch.Tensor:
        """Full-band module (IPDnet2.py:235-253). x: (B, F, T, H). On a
        shard of F the Linear reads the gathered axis and writes this
        shard's bins."""
        nb, f, t, h = x.shape
        y = self.norm_full(x).permute(0, 2, 3, 1).reshape(nb * t, h, f)
        y = F.silu(self.squeeze["0"](y))
        if fx is None:
            y = self.full(y)                         # Linear over freq
        else:
            rows = fx.block(f)
            y = linear(fx.gather(y, -1), self.full.weight[rows],
                       self.full.bias[rows])
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


def get_causal_mask(cfg: SpatialNetConfig, slen: int, device=None):
    """The mask or relative-position tables of ``get_causal_mask``
    (IPDnet2.py:370-399) for a sequence of ``slen`` frames.

    mhsa → the additive (slen, slen) {0, -inf} window mask, or per-head
    ALiBi (heads, slen, slen) when rope='ALiBi'; ret → RetNetRelPos's
    decay/rotary tables in the chunkwise or parallel layout; mamba → None.
    """
    kind = cfg.time_kind
    if kind == "mamba":
        return None
    if kind == "mhsa":
        return torch.as_tensor(causal_mask(
            slen, cfg.attn_scope, cfg.num_heads, alibi=cfg.rope == "ALiBi"),
            device=device)
    pos = RetNetRelPos(cfg.dim_hidden, cfg.num_heads,
                       cfg.recurrent_chunk_size)
    return pos(slen, chunkwise_recurrent=cfg.chunkwise_recurrent,
               device=device)


def _retention_stream(p: Retention, y: torch.Tensor, cfg: SpatialNetConfig,
                      state: RetentionState):
    """Per-frame recurrent retention over a chunk (a loop over its
    frames), numerically the chunkwise/parallel one-shot modes (the
    reference's per-step loop, IPDnet2.py:193-199 + retention.py:174-192).
    ``state.pos`` is one position for the batch or one a row; the tables
    are the module's buffers, so no host copy runs here.
    """
    rope = cfg.rope is True
    kv, scale, pos = state
    outs = []
    for t in range(y.shape[1]):
        # (B or 1, 1, 1, kd): one rotary step a row, or one for the batch
        ang = (p.angle * pos.float().reshape(-1, 1))[:, None, None]
        out, new = retention_recurrent_step(
            p, y[:, t: t + 1], ((torch.sin(ang), torch.cos(ang)), p.decay),
            {"prev_key_value": kv, "scale": scale}, rope=rope)
        kv, scale, pos = new["prev_key_value"], new["scale"], pos + 1
        outs.append(out[:, 0])
    return torch.stack(outs, dim=1), RetentionState(kv, scale, pos)


def _time_block_1(layer: SpatialNetLayer, x: torch.Tensor,
                  cfg: SpatialNetConfig, mask, state):
    """First time module: Mamba / MHSA / retention on (B, F, T, H)."""
    kind = cfg.time_kind
    if kind == "mamba":
        return _mamba_block(layer.norm_mhsa, layer.mhsa, x, state)
    nb, f, t, h = x.shape
    y = layer.norm_mhsa(x).reshape(nb * f, t, h)
    if kind == "mhsa":
        y, new_state = (layer.mhsa(y, mask), None) if state is None \
            else layer.mhsa(y, state=state)
    elif state is not None:
        y, new_state = _retention_stream(layer.mhsa, y, cfg, state)
    else:
        retention = (retention_chunkwise if cfg.chunkwise_recurrent
                     else retention_parallel)
        y, new_state = retention(layer.mhsa, y, mask,
                                 rope=cfg.rope is True), None
    return y.reshape(nb, f, t, h), new_state


def _time_block_2(layer: SpatialNetLayer, x: torch.Tensor,
                  cfg: SpatialNetConfig, state):
    """Second time module: Mamba (mamba mode) or T-ConvFFN (whose LN is
    its own element 0, per the _tconvffn dispatch)."""
    if cfg.time_kind == "mamba":
        return _mamba_block(layer.norm_tconvffn, layer.tconvffn, x, state)
    nb, f, t, h = x.shape
    y = x.reshape(nb * f, t, h)
    y, new_state = (layer.tconvffn(y), None) if state is None \
        else layer.tconvffn(y, state)
    return y.reshape(nb, f, t, h), new_state


class SpatialNet(nn.Module):
    """OnlineSpatialNet with the time modules ``cfg.attention`` selects.
    ``device=None`` is the first CUDA device; weights are the JAX
    package's inits drawn from ``generator``."""

    def __init__(self, cfg: SpatialNetConfig = SpatialNetConfig(), *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
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
                generator: torch.Generator | None = None, freq_mesh=None):
        """Forward. x: (nb, dim_input, nf, nt), the run_IPDnet2 input layout.

        Returns (nb, nt/5, 2·nf, dim_output/4, 2), plus the new
        SpatialNetState when ``return_state``. With ``state``, x continues
        the previous chunk (nt a multiple of the time compression).
        ``generator`` is taken for the task interface; the model has no
        dropout. With a 2-D ``freq_mesh`` x holds this rank's nf/n_freq
        bins (``parallel.freq_sharded_input``) and the output is whole
        along frequency, the same on every rank of the freq group; it
        takes no streaming state.
        """
        cfg = self.cfg
        fx = FreqShard.of(freq_mesh)
        if fx is not None:
            if state is not None or return_state:
                raise ValueError("a frequency-sharded forward carries no "
                                 "streaming state")
            if x.shape[2] * fx.size != cfg.num_freqs:
                raise ValueError(f"{x.shape[2]} bins a shard of "
                                 f"{fx.size} do not make the config's "
                                 f"{cfg.num_freqs}")
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

        masks: dict[int, object] = {}
        new_time = []
        for i in range(cfg.num_layers):
            layer = self.layers[str(i)]
            st = state.time[i] if state is not None else (None, None)
            x = x + _fconv(layer.fconv1, x, fx)
            if i == 0:
                x, fx = _pool_freq(x, 2, fx)
            x = x + layer.full_band(x, fx)
            x = x + _fconv(layer.fconv2, x, fx)
            if i == 0:
                x, fx = _pool_freq(x, cfg.fre_compression_ratio // 2, fx)
            # a fresh mask per distinct sequence length: after the time
            # compression the reference's input-length mask is stale
            t_now = x.shape[2]
            if state is None and t_now not in masks:
                masks[t_now] = get_causal_mask(cfg, t_now, x.device)
            d1, s1 = _time_block_1(layer, x, cfg, masks.get(t_now), st[0])
            x = x + d1
            d2, s2 = _time_block_2(layer, x, cfg, st[1])
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
        if fx is not None:
            z = fx.gather(z, 1)

        # output reshape chain (IPDnet2.py:360-364)
        bsz, f_, t2, _ = z.shape
        z = z.permute(0, 2, 1, 3).reshape(bsz, t2, f_, 2, -1)
        z = z.permute(0, 1, 3, 2, 4)
        z = z.reshape(bsz, t2, 2, f_ * 2, -1)
        out = z.permute(0, 1, 3, 4, 2)
        if return_state:
            return out, SpatialNetState(enc_tail, tuple(new_time))
        return out
