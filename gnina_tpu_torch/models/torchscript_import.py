"""TorchScript -> converted model (op-list spec + numpy parameters).

Parses the frozen, inlined TorchScript graph of a gnina CNN checkpoint
(reference: the 66 embedded models in gninasrc/lib/models/*.pt, executed by
gninasrc/lib/torch_model.cpp) into a small op-list "spec" plus a parameter
dict.  models/runtime.py's SpecModule replays the spec, so every model
family (default2017/default2018/dense and variants) converts without
hand-written architecture code, and numerical parity can be asserted
against torch directly.  A copy of the JAX package's
gnina_tpu/models/torchscript_import.py: the spec and parameters it writes
are the same, so either package reads the other's conversions.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

SUPPORTED_OPS = {
    "aten::max_pool3d", "aten::avg_pool3d", "aten::_convolution",
    "aten::batch_norm", "aten::relu", "aten::relu_", "aten::cat",
    "aten::view", "aten::flatten", "aten::reshape", "aten::linear",
    "aten::log_softmax", "aten::softmax", "aten::squeeze", "aten::sigmoid",
    "aten::t", "aten::addmm", "aten::matmul", "aten::add", "aten::add_",
    "aten::dropout", "aten::feature_dropout", "aten::size",
    "prim::NumToTensor", "aten::Int", "aten::ScalarImplicit",
    "aten::slice", "aten::select", "aten::mul", "aten::where",
    "aten::gt", "aten::lt", "aten::zeros_like", "aten::hstack",
    "aten::zeros", "aten::ones", "aten::sub", "aten::div", "aten::exp",
    "aten::unsqueeze",
}


def _const_value(node):
    import torch

    out = node.output()
    t = out.type().kind()
    if t == "NoneType":
        return None
    attr_names = node.attributeNames()
    if not attr_names:
        return None
    an = attr_names[0]
    k = node.kindOf(an)
    if k == "t":
        return node.t(an).detach().cpu().numpy()
    if k == "i":
        return node.i(an)
    if k == "f":
        return node.f(an)
    if k == "s":
        return node.s(an)
    if k == "is":
        return list(node.ints(an))
    if k == "fs":
        return list(node.fs(an))
    if k == "ival":
        v = node.output().toIValue()
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return v
    return node.output().toIValue()


def import_torchscript(path: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Load a .pt file -> (spec dict, params dict).

    spec = {"metadata": {...}, "ops": [...], "output": [names]}
    Each op: {"op": kind, "out": name, "in": [names], "attrs": {...}}.
    Tensor constants become params entries referenced by name.
    """
    import torch

    extra = {"metadata": ""}
    m = torch.jit.load(path, map_location="cpu", _extra_files=extra)
    m.eval()
    fm = torch.jit.freeze(m)
    g = fm.inlined_graph

    meta = {}
    raw = extra["metadata"]
    if isinstance(raw, bytes):
        raw = raw.decode("utf-8", "ignore")
    if raw:
        try:
            meta = json.loads(raw)
        except json.JSONDecodeError:
            meta = {}

    params: Dict[str, np.ndarray] = {}
    consts: Dict[str, object] = {}
    ops: List[dict] = []

    inputs = list(g.inputs())
    # first graph input is `self` (module), second the tensor input
    input_name = inputs[-1].debugName()

    def ref(v):
        return v.debugName()

    output_names: List[str] = []

    for node in g.nodes():
        kind = node.kind()
        if kind == "prim::Constant":
            val = _const_value(node)
            name = ref(node.output())
            if isinstance(val, np.ndarray):
                pname = f"p{len(params)}"
                params[pname] = val.astype(np.float32)
                consts[name] = ("param", pname)
            else:
                consts[name] = ("const", val)
        elif kind == "prim::ListConstruct":
            vals = []
            for inp in node.inputs():
                c = consts.get(ref(inp))
                if c is None:
                    vals.append(("ref", ref(inp)))
                else:
                    vals.append(c)
            consts[ref(node.output())] = ("list", vals)
        elif kind == "prim::TupleConstruct":
            output_names = [consts.get(ref(i), ("ref", ref(i)))
                            for i in node.inputs()]
            consts[ref(node.output())] = ("tuple", output_names)
        elif kind.startswith("aten::") or kind in (
                "prim::NumToTensor",):
            if kind not in SUPPORTED_OPS:
                raise NotImplementedError(
                    f"{os.path.basename(path)}: unsupported op {kind}")
            in_refs = []
            for inp in node.inputs():
                nm = ref(inp)
                if nm in consts:
                    in_refs.append(consts[nm])
                else:
                    in_refs.append(("ref", nm))
            ops.append({"op": kind, "out": ref(node.output()),
                        "in": in_refs})
        elif kind in ("prim::GetAttr",):
            raise NotImplementedError("graph not fully frozen (GetAttr left)")
        # ignore other prim:: bookkeeping nodes

    graph_out = list(g.outputs())[0]
    if not output_names:
        output_names = [consts.get(ref(graph_out), ("ref", ref(graph_out)))]

    spec = {"metadata": meta, "ops": ops, "output": output_names,
            "input": input_name}
    return spec, params


def convert_and_save(pt_path: str, out_dir: str, name: str) -> str:
    """Convert one checkpoint; writes <name>.spec.json + <name>.npz."""
    os.makedirs(out_dir, exist_ok=True)
    spec, params = import_torchscript(pt_path)
    spec_path = os.path.join(out_dir, f"{name}.spec.json")
    npz_path = os.path.join(out_dir, f"{name}.npz")

    def encode(x):
        if isinstance(x, tuple):
            return list(x)
        return x

    with open(spec_path, "w") as f:
        json.dump(spec, f, default=encode)
    np.savez_compressed(npz_path, **params)
    return spec_path
