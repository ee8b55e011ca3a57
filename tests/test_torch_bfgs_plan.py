"""The host side of the BFGS-loop kernels (k_bfgs, k_lockstep_mc) in
csrc/fused_dock.cu: K8's scratch (the done words, leave counts, lane
overruns and the ring of records a pose keeps so that it need not wait for
its group at every iteration), the wrapper's checks of it, and mirrors of
the constants and entry points the CUDA source and the wrapper must agree
on.  CPU only: the kernels themselves are held against their plain
versions on a card (test_torch_kernels_cuda.py)."""

import os
import re

import numpy as np
import pytest
import torch

from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch.ops import _cuda
from gnina_tpu_torch.ops import fused_dock as fd
from gnina_tpu_torch.scoring.builtin import get_scoring_function

torch.set_num_threads(2)

CU = os.path.join(os.path.dirname(fd.__file__), os.pardir, "csrc",
                  "fused_dock.cu")


def _source():
    with open(CU) as f:
        return f.read()


def test_group_and_ring_constants_match_the_cuda_source():
    """GROUP (poses a done_frac group) and the ring record's size are the
    kernel's."""
    src = _source()
    assert int(re.search(r"#define GROUP (\d+)", src).group(1)) == fd.GROUP
    body = re.search(r"inline int ring_floats\(int M\) \{ return (.*?); \}",
                     src).group(1)
    for m in (1, 4, 12, 40):
        assert eval(body, {"M": m}) == fd.ring_floats(m)


@pytest.mark.parametrize("lanes,m,run_slots,runs", [
    (128, 4, 14, 1),      # K2 refine, lockstep
    (800, 4, 141, 1),     # K4 finish: maxiters 14 x 10 trials + 1 ticks
    (64, 4, 3, 16),       # K5 at the screen's 64 lanes, 16 steps
    (1, 1, 1, 1)])
def test_k8_scratch_layout(lanes, m, run_slots, runs):
    """The scratch holds, in the kernel's order (group_sync), the done words
    of every group (runs x run_slots), a leave count per (group, run), an
    overrun count per lane and a ring of run_slots records per lane; the
    wrapper's views name the words and the overruns where the kernel finds
    them."""
    groups = -(-lanes // fd.GROUP)
    words = groups * runs * run_slots
    leave = groups * runs
    ring = lanes * run_slots * fd.ring_floats(m)
    n = fd.k8_scratch_words(lanes, m, run_slots, runs)
    assert n == words + leave + lanes + ring
    gs = fd._group_scratch(lanes, m, run_slots, runs, 0.9, "cpu")
    assert gs.buf.numel() == n and gs.buf.dtype == torch.int32
    assert not bool(gs.buf.any())
    assert gs.words.shape == (groups, runs * run_slots)
    assert gs.per_group == runs * run_slots
    gs.buf.copy_(torch.arange(n, dtype=torch.int32))
    assert int(gs.words[0, 0]) == 0
    assert int(gs.words[-1, -1]) == words - 1
    assert gs.overrun.shape == (lanes,)
    assert int(gs.overrun[0]) == words + leave
    assert int(gs.overrun[-1]) == words + leave + lanes - 1


def test_k8_ring_is_small_beside_the_card():
    """The ring holds a whole run, so a pose never waits before its run's
    end: at the main path's largest call (K4 at 800 lanes, 141 ticks) the
    scratch is some 13 MB, against 80 GB on the card."""
    n = fd.k8_scratch_words(800, 4, 14 * fd.NUM_TRIALS + 1, 1)
    assert 4 * n < 16 * 2 ** 20


def test_k8_targets_and_checks():
    """done_frac = 1 needs no scratch; done_frac outside (0, 1] raises; the
    target is int(done_frac * 128) (the JAX kernel's count); a negative
    size raises; a call without lanes needs no scratch."""
    assert fd._group_scratch(128, 4, 14, 1, 1.0, "cpu") is None
    assert fd._group_scratch(0, 4, 14, 1, 0.5, "cpu") is None
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError):
            fd._group_scratch(128, 4, 14, 1, bad, "cpu")
    for frac, target in ((0.5, 64), (0.9, 115), (0.75, 96), (0.004, 0)):
        assert fd._group_scratch(128, 4, 14, 1, frac, "cpu").target == target
    for args in ((0, 4, 14, 1), (128, 0, 14, 1), (128, 4, -1, 1),
                 (128, 4, 14, -1)):
        with pytest.raises(ValueError):
            fd.k8_scratch_words(*args)
    assert fd.k8_scratch_words(128, 4, 0, 1) == 1 + 128
    assert fd._run_slots(14, 10, False) == 14
    assert fd._run_slots(14, 10, True) == 141


def test_votes_of_the_words():
    """The words as the plain version's votes: the done count where every
    block of the group arrived, -1 where none did (the words past a stop
    are zeroed by the group's last pose); a word with only some arrivals
    raises.  The last group counts its own blocks."""
    lanes = 200                       # a group of 128 and one of 72
    w = torch.zeros((2, 4), dtype=torch.int32)
    w[0, :2] = torch.tensor([(128 << 16) | 3, (128 << 16) | 90])
    w[1, :3] = torch.tensor([(72 << 16) | 0, (72 << 16) | 7,
                             (72 << 16) | 72])
    v = fd._votes_of(w, lanes)
    assert v.tolist() == [[3, 90, -1, -1], [0, 7, 72, -1]]
    w[1, 3] = (5 << 16) | 1
    with pytest.raises(RuntimeError):
        fd._votes_of(w, lanes)


def test_wrapper_keeps_the_last_overrun():
    """A wrapper starts without an overrun; reset clears it."""
    fd.bfgs_minimize.reset()
    assert fd.bfgs_minimize.overrun is None
    made = fd._Made()
    assert made.n.value == 0 and made.overrun is None


def _c_params(src, name):
    """Parameter count of the C entry point `name` in the source."""
    m = re.search(rf"\bint {name}\((.*?)\)\s*\{{", src, re.S)
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("name", ["gt_eval_fg", "gt_bfgs_minimize",
                                  "gt_async_mc_window",
                                  "gt_lockstep_mc_window"])
def test_bound_signatures_match_the_cuda_entry_points(name):
    """ctypes binds each entry point with as many arguments as the C
    function takes (an older source keeps the same interface, so the A/B
    script binds every build the same way)."""

    class Lib:
        pass

    lib = Lib()
    for fn in ("gt_eval_fg", "gt_bfgs_minimize", "gt_async_mc_window",
               "gt_lockstep_mc_window", "gt_error_string"):
        setattr(lib, fn, type("Fn", (), {})())
    _cuda._bind_fused(lib)
    assert len(getattr(lib, name).argtypes) == _c_params(_source(), name)


def _kernel_body(src, name):
    """The text of a __global__ kernel from its name to its closing brace."""
    start = src.index(f") {name}(")
    return src[start:src.index("\n}\n", start)]


def test_pack_args_mirror_the_cuda_struct():
    """The ctypes argument block is the CUDA PackArgs field for field: the
    pointers, then the ints, the receptor plan's tile last."""
    src = _source()
    body = re.search(r"struct PackArgs \{(.*?)\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        code = line.split("//")[0]
        names += re.findall(r"\*?\s*(\w+)\s*[,;]", code)
    assert names == [f for f, _ in fd._PackArgs._fields_]
    sf = get_scoring_function("vina")
    rng = np.random.default_rng(0)
    k = 2157
    for copies in (8, 50):                # the refine's and finish's lanes
        pack = fd.build_pack([fx.ligand()] * 16,
                             rng.normal(size=(k, 3)) * 20.0,
                             rng.integers(0, 4, k), np.ones(k, np.float32),
                             copies, sf.table, m_pad=4, device="cpu")
        a = fd._pack_args(pack, torch.device("cpu"))
        n, m, ly, kk, lanes = pack.dims
        assert (a.L, a.N, a.M, a.LY, a.K, a.D) == (lanes, n, m, ly, kk,
                                                   5 + m)
        assert a.rec_tile == fd.smem_plan(n, m, 5 + m, kk).rec_tile


def test_kernel_instances_and_their_blocks_an_sm():
    """One instance a kernel and mode, each with 512 threads a block and
    its own pose blocks an SM (MINB_*: 1 or 2, settable with -D), but
    k_bfgs, built for one and for two and picked at launch from the lanes,
    the SM count and the occupancy; the C entry points launch those."""
    src = _source()
    assert int(re.search(r"#define NT (\d+)", src).group(1)) \
        == fd.BLOCK_THREADS
    kernels = {"k_eval_fg": "MINB_EVAL", "k_async_mc": "MINB_ASYNC_MC",
               "k_lockstep_mc": "MINB_LOCKSTEP_MC", "k_bfgs": "MINB"}
    for name, macro in kernels.items():
        assert src.count(f"__launch_bounds__(NT, {macro}) {name}(") == 1
        if macro != "MINB":
            m = re.search(rf"#ifndef {macro}\n#define {macro} (\d+)\n"
                          rf"#endif", src)
            assert m and int(m.group(1)) in (1, 2)
    assert src.count("__launch_bounds__(NT, ") == len(kernels)
    assert "template <bool COUPLED, int MINB>\n__global__" in src
    pick = src[src.index("static int bfgs_kernel("):]
    pick = pick[:pick.index("\n}\n")]
    for inst in ("k_bfgs<true, 1>", "k_bfgs<false, 1>", "k_bfgs<true, 2>",
                 "k_bfgs<false, 2>"):
        assert inst in pick
    assert "pk->L > sms" in pick and "fit >= 2" in pick
    assert "bfgs_kernel(pk, gsync != nullptr, &kernel, &smem)" in src
    for launch in ("(const void*)k_eval_fg;", "(const void*)k_async_mc;",
                   "gsync ? (const void*)k_lockstep_mc<true>",
                   ": (const void*)k_lockstep_mc<false>;"):
        assert launch in src


def test_node_sums_and_trial_gradient_per_kernel():
    """Every kernel's workers run one pair phase (pinned energy sums, so
    that K1's energies are every kernel's); fk_backward's node sums run on
    8 lanes a node in K1, K3 and K5 and on one in k_bfgs, and only K5's
    BFGS loop (GRAD_FIRST) evaluates trial 0 with its gradient."""
    src = _source()
    lanes = {"k_eval_fg": "8", "k_async_mc": "8"}
    for name in ("k_eval_fg", "k_bfgs", "k_async_mc", "k_lockstep_mc"):
        body = _kernel_body(src, name)
        assert body.count("worker_loop(c)") == 1
        for nl in re.findall(r"eval_pose<\w+, (\w+)>", body):
            assert nl == lanes[name]
    assert "bfgs_run<COUPLED, false>" in _kernel_body(src, "k_bfgs")
    assert "bfgs_run<COUPLED, true>" in _kernel_body(src, "k_lockstep_mc")
    run = src[src.index("BfgsResult bfgs_run(Ctx& c"):]
    run = run[:run.index("// K2 / K4")]
    assert "constexpr int NL = GRAD_FIRST ? 8 : 1;" in run
    assert run.count("eval_pose<true, NL>(c,") == 3
    assert run.count("eval_pose<false, NL>(c,") == 1
    assert "grad = GRAD_FIRST;" in run
    terms = src[src.index("void pair_terms("):]
    terms = terms[:terms.index("\n}\n")]
    assert terms.count("__fmaf_rn(") == 3


def _mangled(name, params):
    """The Itanium C++ name of a function `name` taking `params`, for the
    parameter types K3 uses (its structs, int, uint32_t, float, float*,
    const float*), with the ABI's substitutions of repeated types."""
    seen = []

    def sub(code):
        if code in seen:
            i = seen.index(code)
            return "S_" if i == 0 else f"S{i - 1}_"
        return None

    def mangle(t):
        t = " ".join(t.split())
        if t.endswith("*"):
            inner = t[:-1].strip()
            const = inner.startswith("const ")
            base = {"float": "f"}[inner.replace("const ", "")]
            full = "P" + ("K" if const else "") + base
            if sub(full):
                return sub(full)
            if const and "K" + base not in seen:
                seen.append("K" + base)
            seen.append(full)
            return full
        builtin = {"int": "i", "uint32_t": "j", "float": "f"}
        if t in builtin:
            return builtin[t]
        code = f"{len(t)}{t}"
        if sub(code):
            return sub(code)
        seen.append(code)
        return code

    return f"_Z{len(name)}{name}" + "".join(mangle(p) for p in params)


def test_k3_symbol_is_the_kernels_name_in_the_library():
    """fused_dock.K3_SYMBOL, by which the occupancy query finds K3 in the
    library's device code, is k_async_mc's C++ name for its parameters in
    the source."""
    src = _source()
    m = re.search(r"\) k_async_mc\((.*?)\)\s*\{", src, re.S)
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    assert fd.K3_SYMBOL == _mangled("k_async_mc", params)
    assert _mangled("k_eval_fg", ["PackArgs", "TermArgs", "const float *",
                                  "const float *", "const float *",
                                  "float *", "float *", "float *",
                                  "float *"]) == \
        "_Z9k_eval_fg8PackArgs8TermArgsPKfS2_S2_PfS3_S3_S3_"


def test_fatbin_images_walk_the_section():
    """The .nv_fatbin section's fatbinaries, each its header and payload,
    the next at the following 8-byte boundary; a section that is not made
    of them raises."""
    import struct

    def image(payload):
        return struct.pack("<IHHQ", _cuda.FATBIN_MAGIC, 1, 16,
                           len(payload)) + payload

    a, b = image(b"x" * 984), image(b"kernels" * 3)
    section = a + b + bytes(-len(b) % 8)
    assert _cuda.fatbin_images(section) == [a, b]
    assert _cuda.fatbin_images(a) == [a]
    with pytest.raises(RuntimeError):
        _cuda.fatbin_images(a + b"\0" * 16)
