"""The initial model, drawn on the device from the seed in one call.

``layout(cfg)`` lists every leaf of the decoder as ``(name, shape, init)``
in the order and under the names the port's params tree flattens to
(``repro_torch.tree.flatten_with_path``), layers stacked on a leading axis.
``draw`` fills them from one truncated-normal draw of all the weights: the
port's init rule (sigma 0.02 for the embedding and the router, else
``1/sqrt(fan_in)`` with ``fan_in`` a layer leaf's first axis; norm scales 1,
biases 0), truncated at two sigma.  The benchmark hands the same tensors to
the program and to the reference.
"""

from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)
_CDF_LO = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
_CDF_HI = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))
_CHUNK = 1 << 28  # values a slice of the draw turns into normals at once


def _vocab(cfg: dict) -> int:
    m = cfg["vocab_pad_to"]
    return -(-cfg["vocab_size"] // m) * m


def layout(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """``(name, shape, init)`` of every leaf; ``init`` is ``"ones"``,
    ``"zeros"`` or ``"normal:<sigma>"``."""
    L, D = cfg["n_layers"], cfg["d_model"]
    H, KVH = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["head_dim"] or D // H
    V = _vocab(cfg)

    def dense(shape):  # a layer leaf: fan_in is its own first axis
        return "normal:%r" % (1.0 / math.sqrt(shape[0]))

    layer: dict[str, tuple[tuple[int, ...], str]] = {
        "['attn']['wk']": ((D, KVH * hd), None),
        "['attn']['wo']": ((H * hd, D), None),
        "['attn']['wq']": ((D, H * hd), None),
        "['attn']['wv']": ((D, KVH * hd), None),
        "['norm1']['scale']": ((D,), "ones"),
        "['norm2']['scale']": ((D,), "ones"),
    }
    if cfg["qkv_bias"]:
        layer["['attn']['bk']"] = ((KVH * hd,), "zeros")
        layer["['attn']['bq']"] = ((H * hd,), "zeros")
        layer["['attn']['bv']"] = ((KVH * hd,), "zeros")
    if cfg["n_experts"]:
        m = cfg["expert_pad_to"]
        E = -(-cfg["n_experts"] // m) * m
        F = cfg["moe_d_ff"]
        layer["['moe']['router']"] = ((D, E), "normal:0.02")
        layer["['moe']['we_down']"] = ((E, F, D), None)
        layer["['moe']['we_gate']"] = ((E, D, F), None)
        layer["['moe']['we_up']"] = ((E, D, F), None)
        if cfg["n_shared_experts"]:
            S = cfg["shared_d_ff"] or F * cfg["n_shared_experts"]
            layer["['moe']['shared']['w_down']"] = ((S, D), None)
            layer["['moe']['shared']['w_gate']"] = ((D, S), None)
            layer["['moe']['shared']['w_up']"] = ((D, S), None)
    else:
        F = cfg["d_ff"]
        layer["['mlp']['w_down']"] = ((F, D), None)
        layer["['mlp']['w_gate']"] = ((D, F), None)
        layer["['mlp']['w_up']"] = ((D, F), None)

    leaves = [("['embed']", (V, D), "normal:0.02"),
              ("['final_norm']['scale']", (D,), "ones")]
    if not cfg["tie_embeddings"]:
        leaves.append(("['lm_head']", (D, V), "normal:%r" % (1.0 / math.sqrt(D))))
    for key in sorted(layer):
        shape, init = layer[key]
        leaves.append((f"['segments'][0][0]{key}", (L, *shape), init or dense(shape)))
    return leaves


def param_count(cfg: dict) -> int:
    """Parameters of the model ``layout`` describes."""
    return sum(math.prod(shape) for _, shape, _ in layout(cfg))


def weight_generator(seed: int, device: torch.device) -> torch.Generator:
    """The weights' own stream, apart from the data's."""
    return torch.Generator(device=device).manual_seed((int(seed) * 2) % (2 ** 63))


def draw(cfg: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Every leaf by name, f32 on ``device``: views of one flat buffer."""
    leaves = layout(cfg)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    gen = weight_generator(seed, device)
    for start in range(0, flat.shape[0], _CHUNK):
        part = flat[start: start + _CHUNK]
        torch.rand(part.shape, generator=gen, device=device, out=part)
        part.mul_(_CDF_HI - _CDF_LO).add_(_CDF_LO).mul_(2.0).sub_(1.0).erfinv_()
        part.mul_(_SQRT2).clamp_(-2.0, 2.0)
    out, offset = {}, 0
    for (name, shape, init), size in zip(leaves, sizes):
        leaf = flat[offset: offset + size].view(shape)
        offset += size
        if init == "ones":
            leaf.fill_(1.0)
        elif init == "zeros":
            leaf.zero_()
        else:
            leaf.mul_(float(init.split(":")[1]))
        out[name] = leaf
    return out
