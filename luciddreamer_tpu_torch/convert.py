"""Carry state across from the JAX package: its ``GaussianParams``,
``Camera`` and ``TrainState`` fields and its ZoeDepth parameter trees,
given as numpy arrays, become the port's objects.

No JAX import: callers pass ``np.asarray`` of each field.
"""
from __future__ import annotations

import numpy as np
import torch

from luciddreamer_tpu_torch.core.types import Camera, GaussianParams
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.train.checkpoint import state_from_dict

GAUSSIAN_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity", "alive")
CAMERA_ARRAYS = ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy")


def gaussian_params(arrays: dict, device=None) -> GaussianParams:
    """``arrays`` maps every name in GAUSSIAN_FIELDS to a numpy array."""
    dev = resolve_device(device)
    t = {k: torch.as_tensor(np.array(arrays[k]), device=dev)
         for k in GAUSSIAN_FIELDS}
    return GaussianParams(
        **{k: v.to(torch.float32) for k, v in t.items() if k != "alive"},
        alive=t["alive"].to(torch.bool),
    )


def camera(arrays: dict, height: int, width: int, znear: float = 0.01,
           zfar: float = 100.0, device=None) -> Camera:
    """``arrays`` maps every name in CAMERA_ARRAYS to a numpy array."""
    dev = resolve_device(device)
    f32 = lambda k: torch.as_tensor(np.array(arrays[k], np.float32), device=dev)
    return Camera(**{k: f32(k) for k in CAMERA_ARRAYS}, height=int(height),
                  width=int(width), znear=znear, zfar=zfar)


def train_state(tree: dict, device=None):
    """A JAX ``TrainState`` as the nested dict of numpy arrays that
    ``luciddreamer_tpu/train/checkpoint.py::_state_to_pytree`` builds
    (params with alive, adam count/mu/nu, stats, step) -> the port's
    ``TrainState``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.as_tensor(np.array(x), device=dev)

    return state_from_dict(conv(tree))


# ---------------------------------------------------------------- ZoeDepth
# A flax parameter tree of ``FlaxZoeDepth`` / ``FlaxZoeDepthNK`` (or of a
# bare ``DPT``) -> the state dict of the port's module, whose names are the
# reference checkpoints'.  The inverse of the JAX package's
# ``models/convert.py``: conv kernels HWIO -> OIHW, transposed-conv kernels
# un-flipped to (I, O, kh, kw), dense kernels transposed, LayerNorm scale ->
# weight, the packed qkv bias split into q_bias and v_bias (the k third is
# dropped: softmax cancels a k bias exactly).  Rel-pos tables are taken at
# the grid the tree was initialised for.

def _conv(p):
    out = {"weight": np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _conv_t(p):
    k = np.asarray(p["kernel"], np.float32)[::-1, ::-1]
    out = {"weight": k.transpose(2, 3, 0, 1)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _dense(p):
    out = {"weight": np.asarray(p["kernel"], np.float32).T}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _norm(p):
    return {"weight": p["scale"], "bias": p["bias"]}


def _put(sd, prefix, entries):
    for name, v in entries.items():
        sd[f"{prefix}.{name}"] = torch.from_numpy(np.array(v, np.float32))


def _net(sd, prefix, p, a="c1", b="c2"):
    """A 1x1-conv MLP: flax c1/c2 -> the reference's Sequential 0/2."""
    _put(sd, f"{prefix}.0", _conv(p[a]))
    _put(sd, f"{prefix}.2", _conv(p[b]))


def dpt_state_dict(tree: dict) -> dict:
    """The flax tree of a ``DPT`` -> the port's ``DPT`` state dict."""
    sd: dict = {}
    vit = tree["vit"]
    bb = "pretrained.model"
    _put(sd, f"{bb}.patch_embed.proj", _conv(vit["patch_embed"]))
    _put(sd, bb, {"cls_token": vit["cls_token"]})
    i = 0
    while f"block{i}" in vit:
        blk, b = vit[f"block{i}"], f"{bb}.blocks.{i}"
        qkv = blk["attn"]["qkv"]
        C = np.shape(qkv["bias"])[0] // 3
        _put(sd, f"{b}.norm1", _norm(blk["norm1"]))
        _put(sd, f"{b}.norm2", _norm(blk["norm2"]))
        _put(sd, b, {"gamma_1": blk["gamma1"], "gamma_2": blk["gamma2"]})
        _put(sd, f"{b}.attn", {
            "qkv.weight": _dense(qkv)["weight"],
            "q_bias": np.asarray(qkv["bias"])[:C],
            "v_bias": np.asarray(qkv["bias"])[2 * C:],
        })
        _put(sd, f"{b}.attn.proj", _dense(blk["attn"]["proj"]))
        if "rel_pos" in blk["attn"]:
            _put(sd, f"{b}.attn", {"relative_position_bias_table":
                                   blk["attn"]["rel_pos"]["rel_pos_table"]})
        _put(sd, f"{b}.mlp.fc1", _dense(blk["fc1"]))
        _put(sd, f"{b}.mlp.fc2", _dense(blk["fc2"]))
        i += 1
    for k in range(4):
        ap = f"pretrained.act_postprocess{k + 1}"
        if f"readout{k}" in tree:
            _put(sd, f"{ap}.0.project.0", _dense(tree[f"readout{k}"]["project"]))
        _put(sd, f"{ap}.3", _conv(tree[f"project{k}"]))
        if k in (0, 1):
            _put(sd, f"{ap}.4", _conv_t(tree[f"resample{k}"]))
        elif k == 3:
            _put(sd, f"{ap}.4", _conv(tree[f"resample{k}"]))
        _put(sd, f"scratch.layer{k + 1}_rn", _conv(tree[f"layer{k}_rn"]))
    for k in range(1, 5):
        fusion, rf = tree[f"fusion{k}"], f"scratch.refinenet{k}"
        for unit, name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            if unit in fusion:
                for conv in ("conv1", "conv2"):
                    _put(sd, f"{rf}.{name}.{conv}", _conv(fusion[unit][conv]))
        _put(sd, f"{rf}.out_conv", _conv(fusion["out_conv"]))
    for j, head in enumerate(("head1", "head2", "head3")):
        _put(sd, f"scratch.output_conv.{2 * j}", _conv(tree[head]))
    return sd


def zoedepth_state_dict(tree: dict, kind: str = "zoedepth") -> dict:
    """The flax parameter tree of a ``FlaxZoeDepth`` (``kind`` 'zoedepth',
    N or K) or ``FlaxZoeDepthNK`` ('zoedepth_nk'), with or without its
    'params' level -> the state dict of the port's ``ZoeDepth`` or
    ``ZoeDepthNK``."""
    p = tree.get("params", tree)
    sd = {f"core.core.{k}": v for k, v in dpt_state_dict(p["core"]).items()}
    _put(sd, "conv2", _conv(p["conv2"]))
    _net(sd, "seed_projector._net", p["seed_projector"])
    i = 0
    while f"projector{i}" in p:
        _net(sd, f"projectors.{i}._net", p[f"projector{i}"])
        i += 1
    if kind == "zoedepth":
        _net(sd, "seed_bin_regressor._net", p["seed_bin_regressor"])
        for j in range(i):
            _net(sd, f"attractors.{j}._net", p[f"attractor{j}"])
        _net(sd, "conditional_log_binomial.mlp",
             p["conditional_log_binomial"], "mlp1", "mlp2")
        return sd
    if kind != "zoedepth_nk":
        raise ValueError(f"unknown ZoeDepth kind {kind!r}")
    _put(sd, "mlp_classifier.0", _dense(p["cls1"]))
    _put(sd, "mlp_classifier.2", _dense(p["cls2"]))
    pt = p["patch_transformer"]
    _put(sd, "patch_transformer.embedding_convPxP", _conv(pt["embed"]))
    layer = 0
    while f"layer{layer}" in pt:
        q, b = pt[f"layer{layer}"], \
            f"patch_transformer.transformer_encoder.layers.{layer}"
        _put(sd, f"{b}.self_attn", {"in_proj_weight": _dense(q["qkv"])["weight"],
                                    "in_proj_bias": q["qkv"]["bias"]})
        _put(sd, f"{b}.self_attn.out_proj", _dense(q["proj"]))
        _put(sd, f"{b}.linear1", _dense(q["fc1"]))
        _put(sd, f"{b}.linear2", _dense(q["fc2"]))
        _put(sd, f"{b}.norm1", _norm(q["norm1"]))
        _put(sd, f"{b}.norm2", _norm(q["norm2"]))
        layer += 1
    names = [k[len("clb_"):] for k in p if k.startswith("clb_")]
    for name in names:
        _net(sd, f"seed_bin_regressors.{name}._net", p[f"seed_bin_{name}"])
        for j in range(i):
            _net(sd, f"attractors.{name}.{j}._net", p[f"attractor{j}_{name}"])
        _net(sd, f"conditional_log_binomial.{name}.mlp", p[f"clb_{name}"],
             "mlp1", "mlp2")
    return sd
