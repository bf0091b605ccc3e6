"""Normalization zoo, grouped linears and the non-linear factory (port of
``fnssl_tpu/models/norms.py``, functional: parameters are mappings of
tensors under the reference's names).

Functional equivalents of IPDnet2/arch/base/{norm,linear_group,
non_linear}.py with the reference's parameter shapes and semantics:
  * layer_norm / global_layer_norm (gLN) / batch_norm_1d (batch
    statistics) / group_norm / group_batch_norm (NBC2 narrow-band group
    statistics) and the ``new_norm`` factory;
  * linear_group (per-group weights), linear_group_shared, conv1d_group;
  * prelu with a ``dim`` argument and the ``new_non_linear`` factory.
Inits draw from a torch generator with the JAX package's rules. No
model of either package uses this module.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fnssl_tpu_torch.models.layers import uniform_


def _var(x, dim):
    return x.var(dim=dim, keepdim=True, unbiased=False)


# ---------------------------------------------------------------- norms


def init_affine(dim: int, seq_last: bool = False, device=None):
    shape = (dim, 1) if seq_last else (dim,)
    return {"weight": torch.ones(shape, device=device),
            "bias": torch.zeros(shape, device=device)}


def layer_norm(p, x, seq_last: bool = False, eps: float = 1e-5):
    """LN over the hidden dim; seq_last puts hidden at axis 1
    (norm.py:11-27)."""
    if seq_last:
        x = x.transpose(-1, 1)
    mean = x.mean(dim=-1, keepdim=True)
    out = ((x - mean) * torch.rsqrt(_var(x, -1) + eps)
           * p["weight"].reshape(-1) + p["bias"].reshape(-1))
    return out.transpose(-1, 1) if seq_last else out


def global_layer_norm(p, x, seq_last: bool = False, eps: float = 1e-5):
    """gLN: statistics over (Seq, H) jointly (norm.py:30-60)."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    return ((x - mean) * torch.rsqrt(_var(x, (1, 2)) + eps) * p["weight"]
            + p["bias"])


def batch_norm_1d(p, x, seq_last: bool = True, eps: float = 1e-5):
    """Batch norm computing batch statistics on the fly (train-mode
    semantics; the reference never runs eval-mode BN in its configs)."""
    if not seq_last:
        x = x.transpose(-1, -2)                      # (B, H, Seq)
    mean = x.mean(dim=(0, 2), keepdim=True)
    out = (x - mean) * torch.rsqrt(_var(x, (0, 2)) + eps)
    out = out * p["weight"].reshape(1, -1, 1) + p["bias"].reshape(1, -1, 1)
    return out.transpose(-1, -2) if not seq_last else out


def group_norm(p, x, num_groups: int, seq_last: bool = True,
               eps: float = 1e-5):
    """torch GroupNorm semantics on (B, H, ...) (norm.py:80-91)."""
    if not seq_last:
        x = x.transpose(-1, 1)
    b, h = x.shape[:2]
    rest = tuple(x.shape[2:])
    g = x.reshape((b, num_groups, h // num_groups) + rest)
    axes = tuple(range(2, g.ndim))
    mean = g.mean(dim=axes, keepdim=True)
    g = (g - mean) * torch.rsqrt(_var(g, axes) + eps)
    out = g.reshape((b, h) + rest)
    shape = (1, h) + (1,) * len(rest)
    out = out * p["weight"].reshape(shape) + p["bias"].reshape(shape)
    return out.transpose(-1, 1) if not seq_last else out


def group_batch_norm(p, x, group_size: int, seq_last: bool = False,
                     share_along_sequence_dim: bool = False,
                     eps: float = 1e-5):
    """NBC2 GroupBatchNorm (norm.py:93-227): statistics over the group of
    narrow-band sequences, (group, H) or (group, Seq, H) per group.

    x: (B·group, Seq, H) [seq_last=False] or (B·group, H, Seq).
    """
    shape0 = x.shape
    if x.ndim == 3:
        b = x.shape[0] // group_size
        x = x.reshape((b, group_size) + tuple(x.shape[1:]))
    if seq_last:  # (B, G, H, Seq)
        axes = (1, 2, 3) if share_along_sequence_dim else (1, 2)
        wshape = (1, 1, -1, 1)
    else:         # (B, G, Seq, H)
        axes = (1, 2, 3) if share_along_sequence_dim else (1, 3)
        wshape = (1, 1, 1, -1)
    mean = x.mean(dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(_var(x, axes) + eps)
    out = out * p["weight"].reshape(wshape) + p["bias"].reshape(wshape)
    return out.reshape(shape0)


def new_norm(norm_type: str, dim_hidden: int, seq_last: bool,
             group_size: int | None = None, num_groups: int | None = None):
    """Factory returning (init_params, apply(params, x)) pairs
    (norm.py:230-247)."""
    t = norm_type
    if t.upper() == "LN":
        return (lambda: init_affine(dim_hidden),
                lambda p, x: layer_norm(p, x, seq_last))
    if t.upper() == "GBN" or t == "GBNShare":
        share = t == "GBNShare"
        return (lambda: init_affine(dim_hidden, seq_last),
                lambda p, x, gs=group_size: group_batch_norm(
                    p, x, gs, seq_last, share))
    if t.upper() == "BN":
        return (lambda: init_affine(dim_hidden),
                lambda p, x: batch_norm_1d(p, x, seq_last))
    if t.upper() == "GN":
        return (lambda: init_affine(dim_hidden),
                lambda p, x: group_norm(p, x, num_groups, seq_last))
    if t == "gLN":
        return (lambda: init_affine(dim_hidden, seq_last),
                lambda p, x: global_layer_norm(p, x, seq_last))
    raise ValueError(norm_type)


# ------------------------------------------------------- grouped linears


def _kaiming_uniform(shape, fan_in, generator):
    gain = math.sqrt(2.0 / (1 + 5.0))        # a=sqrt(5) leaky-relu gain
    w = torch.empty(shape)
    uniform_(w, gain * math.sqrt(3.0 / fan_in), generator)
    return w


def _bias(shape, fan_in, generator):
    b = torch.empty(shape)
    uniform_(b, 1 / math.sqrt(fan_in), generator)
    return b


def init_linear_group(in_features: int, out_features: int, num_groups: int,
                      bias: bool = True,
                      generator: torch.Generator | None = None):
    p = {"weight": _kaiming_uniform(
        (num_groups, out_features, in_features), in_features, generator)}
    if bias:
        p["bias"] = _bias((num_groups, out_features), in_features, generator)
    return p


def linear_group(p, x):
    """x: [..., group, in] → [..., group, out] (linear_group.py:29-34)."""
    out = torch.einsum("...gh,gkh->...gk", x, p["weight"])
    return out + p["bias"] if "bias" in p else out


def init_linear_group_shared(in_features: int, out_features: int,
                             num_groups: int, bias: bool = True,
                             generator: torch.Generator | None = None):
    p = {"weight": _kaiming_uniform((out_features, in_features),
                                    in_features, generator)}
    if bias:
        p["bias"] = _bias((num_groups, out_features), in_features, generator)
    return p


def linear_group_shared(p, x):
    out = torch.einsum("...gh,kh->...gk", x, p["weight"])
    return out + p["bias"] if "bias" in p else out


def init_conv1d_group(in_features: int, out_features: int, num_groups: int,
                      kernel_size: int, bias: bool = True,
                      generator: torch.Generator | None = None):
    fan_in = in_features * kernel_size
    p = {"weight": _kaiming_uniform(
        (num_groups, out_features, in_features, kernel_size), fan_in,
        generator)}
    if bias:
        p["bias"] = _bias((num_groups, out_features), fan_in, generator)
    return p


def conv1d_group(p, x):
    """x: (B, T, G, F) → (B, T, G, O); per-group conv over time with
    'same' padding (linear_group.py:106-117)."""
    k = p["weight"].shape[-1]
    xp = F.pad(x, (0, 0, 0, 0, k // 2, k - 1 - k // 2))
    t = x.shape[1]
    win = torch.stack([xp[:, i: i + t] for i in range(k)], dim=-1)
    out = torch.einsum("btgfk,gofk->btgo", win, p["weight"])
    return out + p["bias"] if "bias" in p else out


# --------------------------------------------------------- non-linears


def new_non_linear(non_linear_type: str, dim_hidden: int, seq_last: bool):
    """Factory returning (init_params, apply) (non_linear.py:19-33)."""
    t = non_linear_type.lower()
    if t == "prelu":
        axis = 1 if seq_last else -1

        def apply(p, x):
            shape = [1] * x.ndim
            shape[axis] = -1
            return torch.where(x >= 0, x, p["weight"].reshape(shape) * x)

        return (lambda: {"weight": torch.full((dim_hidden,), 0.25)}, apply)
    fns = {"silu": F.silu, "sigmoid": torch.sigmoid, "relu": F.relu,
           "leakyrelu": F.leaky_relu, "elu": F.elu}
    if t in fns:
        return (lambda: {}), (lambda p, x: fns[t](x))
    raise ValueError(non_linear_type)
