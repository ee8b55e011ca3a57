"""The reference's executor of converted gnina CNN specs (a `.spec.json`
op list and `.npz` weights, as the repository keeps them): the op list
replayed with torch.nn.functional.  A frozen copy of the port's
models/runtime.py (its `execute`, `normalize_spec` and `load_spec`), kept
here so that the reference imports nothing of the port; the convolutions
and matrix products are library calls, in the precision that the caller
sets (`torch.backends.cudnn.allow_tf32`).
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F



def _resolve(arg, env, params):
    tag = arg[0]
    if tag == "ref":
        return env[arg[1]]
    if tag == "param":
        return params[arg[1]]
    if tag == "const":
        return arg[1]
    if tag == "list":
        return [_resolve(a, env, params) for a in arg[1]]
    if tag == "tuple":
        return [env[n] for n in arg[1]]
    raise ValueError(f"bad arg {arg}")


def _pool_args(kernel, stride, pad):
    if not stride:  # torch semantics: empty stride list means stride=kernel
        stride = kernel
    return tuple(kernel), tuple(stride), tuple(pad)


def _names(arg):
    """Environment names an argument reads."""
    if arg[0] == "ref":
        return [arg[1]]
    if arg[0] == "list":
        return [n for a in arg[1] for n in _names(a)]
    if arg[0] == "tuple":
        return list(arg[1])
    return []


def execute(spec: dict, params: Dict[str, torch.Tensor], x: torch.Tensor):
    """Run the converted model.  x: (B, C, D, H, W).  Returns the list of
    outputs, [pose_log_softmax (B, 2), affinity (B,)] for the standard
    models.  An intermediate is dropped after the last op that reads it, so
    the dense models' peak memory is that of the live activations, not of
    every activation of the pass."""
    env = {spec["input"]: x}
    batch = x.shape[0]
    last_use = {}
    for i, op in enumerate(spec["ops"]):
        for a in op["in"]:
            for n in _names(a):
                last_use[n] = i
    keep = {o if isinstance(o, str) else n for o in spec["output"]
            for n in ([o] if isinstance(o, str) else _names(o))}

    for i, op in enumerate(spec["ops"]):
        kind = op["op"]
        args = op["in"]

        def A(i):
            return _resolve(args[i], env, params)

        if kind == "aten::max_pool3d":
            k, s, p = _pool_args(A(1), A(2), A(3))
            out = F.max_pool3d(A(0), k, s, p)
        elif kind == "aten::avg_pool3d":
            k, s, p = _pool_args(A(1), A(2), A(3))
            # padded cells count in the divisor (sum / prod(kernel))
            out = F.avg_pool3d(A(0), k, s, p, count_include_pad=True)
        elif kind == "aten::_convolution":
            out = F.conv3d(A(0), A(1), A(2), stride=tuple(A(3)),
                           padding=tuple(A(4)), dilation=tuple(A(5)))
        elif kind == "aten::batch_norm":
            xin, w, b, mean, var = A(0), A(1), A(2), A(3), A(4)
            eps = A(7)
            scale = w / torch.sqrt(var + eps)
            shift = b - mean * scale
            out = xin * scale.reshape(1, -1, 1, 1, 1) + \
                shift.reshape(1, -1, 1, 1, 1)
        elif kind in ("aten::relu", "aten::relu_"):
            out = torch.clamp(A(0), min=0.0)
        elif kind == "aten::sigmoid":
            out = torch.sigmoid(A(0))
        elif kind == "aten::cat":
            out = torch.cat(A(0), dim=A(1))
        elif kind in ("aten::view", "aten::reshape"):
            shape = [batch if (i == 0 and s == -1) else s
                     for i, s in enumerate(A(1))]
            out = torch.reshape(A(0), shape)
        elif kind == "aten::flatten":
            xin = A(0)
            start = A(1) if len(args) > 1 and args[1][0] == "const" \
                and args[1][1] is not None else 1
            out = torch.reshape(xin, tuple(xin.shape[:start]) + (-1,))
        elif kind == "aten::linear":
            out = F.linear(A(0), A(1), A(2))
        elif kind == "aten::t":
            out = A(0).T
        elif kind == "aten::addmm":
            out = A(0) + torch.matmul(A(1), A(2))
        elif kind == "aten::matmul":
            out = torch.matmul(A(0), A(1))
        elif kind == "aten::size":
            out = A(0).shape[A(1)]
        elif kind in ("prim::NumToTensor", "aten::Int",
                      "aten::ScalarImplicit"):
            out = A(0)
        elif kind in ("aten::add", "aten::add_"):
            out = A(0) + A(1)
        elif kind == "aten::log_softmax":
            out = F.log_softmax(A(0), dim=A(1))
        elif kind == "aten::softmax":
            out = F.softmax(A(0), dim=A(1))
        elif kind == "aten::squeeze":
            out = torch.squeeze(A(0), dim=A(1))
        elif kind in ("aten::dropout", "aten::feature_dropout"):
            out = A(0)  # inference mode
        elif kind == "aten::slice":
            xin, dim, start, end = A(0), A(1), A(2), A(3)
            step = A(4) if len(args) > 4 else 1
            size = xin.shape[dim]
            start = 0 if start is None else (start + size if start < 0
                                             else start)
            end = size if end is None or end > size else (
                end + size if end < 0 else end)
            idx = [slice(None)] * xin.dim()
            idx[dim] = slice(start, end, step)
            out = xin[tuple(idx)]
        elif kind == "aten::select":
            out = torch.select(A(0), A(1), A(2))
        elif kind == "aten::mul":
            out = A(0) * A(1)
        elif kind == "aten::sub":
            out = A(0) - A(1)
        elif kind == "aten::div":
            out = A(0) / A(1)
        elif kind == "aten::exp":
            out = torch.exp(A(0))
        elif kind == "aten::where":
            out = torch.where(A(0), A(1), A(2))
        elif kind == "aten::gt":
            out = A(0) > A(1)
        elif kind == "aten::lt":
            out = A(0) < A(1)
        elif kind == "aten::zeros_like":
            out = torch.zeros_like(A(0))
        elif kind == "aten::zeros":
            out = torch.zeros(tuple(A(0)), dtype=torch.float32,
                              device=x.device)
        elif kind == "aten::ones":
            out = torch.ones(tuple(A(0)), dtype=torch.float32,
                             device=x.device)
        elif kind == "aten::hstack":
            out = torch.hstack(A(0))
        elif kind == "aten::unsqueeze":
            out = torch.unsqueeze(A(0), A(1))
        else:
            raise NotImplementedError(kind)
        env[op["out"]] = out
        for a in args:
            for n in _names(a):
                if last_use[n] == i and n not in keep:
                    env.pop(n, None)

    outs = []
    for o in spec["output"]:
        if isinstance(o, str):  # legacy spec format: plain env names
            outs.append(env[o])
        else:
            outs.append(_resolve(o, env, params))
    return outs


def normalize_spec(spec: dict) -> dict:
    """The spec with its argument lists as tagged tuples (JSON gives
    lists); idempotent."""
    def tupled(x):
        if isinstance(x, (list, tuple)) and len(x) and x[0] in (
                "ref", "param", "const", "list", "tuple"):
            if x[0] == "list":
                return (x[0], [tupled(v) for v in x[1]])
            return tuple(x)
        return x

    spec = dict(spec)
    spec["ops"] = [dict(op, **{"in": [tupled(a) for a in op["in"]]})
                   for op in spec["ops"]]
    spec["output"] = [o if isinstance(o, str) else tupled(o)
                      for o in spec["output"]]
    return spec


def load_spec(spec_path: str, npz_path: str):
    """(spec, numpy parameters) of a converted model."""
    with open(spec_path) as f:
        spec = normalize_spec(json.load(f))
    raw = np.load(npz_path)
    return spec, {k: raw[k] for k in raw.files}
