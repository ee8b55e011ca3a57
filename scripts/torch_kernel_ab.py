"""Time the fused docking kernels of several builds of csrc/fused_dock.cu on
one card, in turns (A, B, ..., ..., B, A), at the main path's shapes.

    python scripts/torch_kernel_ab.py OLD.cu NEW.cu[:NAME=VALUE,...] [...]

Each source is compiled with the port's nvcc flags (and -DNAME=VALUE for
each definition after its colon, e.g. NEW.cu:MINB_EVAL=1 to build k_eval_fg
for one pose block an SM) into its own library under
gnina_tpu_torch/_build/ab/ and bound in place of the package's; a source
from before the shared-memory plan (no `rec_tile` in its PackArgs) gets the
older argument block.  For each source it prints, in ms,
on the main path's receptor (a 20 A box, K=2,157 at seed 0), the median of
calls made alone between CUDA events (the host's time to make the call
counts), the mean of calls made back to back (it overlaps the card's), and
the kernels' own time a call on the card from torch.profiler (the
durations of the port's kernels, host time excluded; the one to compare
kernels by, since the host's share varies with the machine's load):

  K3      one async window (L=128, S=128, tick budget 16, the main path's
          miniters, Philox); K6 the same window under warm_ls
  K2, K4  bfgs_minimize in both line-search modes at the refine shape
          (L=128, caps 1000, from perturbed poses) and the finish shape
          (L=800, slope 1e5, from minima like the container's)
  K5      one lockstep window (L=128, S=16, miniters, Philox)
  K8      K2 and K4 at both shapes and K5 with done_frac = 0.9
  K1      eval_fg (L=128, and L=800 as the exact rescore runs it)

Every source sees the same starts (made once, before the turns, with the
last source).  For each source whose K1 has a value-only mode it first
prints whether those energies equal the value+gradient ones bit for bit.  The last source is also timed on a receptor above the
shared-memory budget (a 34 A box, K=6,154: K3 and K1), and the card's name
and power limit close the output, after a table of each row's median over
the turns.

    python scripts/torch_kernel_ab.py --probes OLD/probes.cu NEW/probes.cu

does the same for builds of csrc/probes.cu: K9 (f32, bf16), K10 and K11
at the probes' default sizes (L=128, N=32, K=1280, 20 repetitions), each
build through the same host path, whichever entry points it has (see
build_probes), then for the last build K10 beside an empty kernel on its
grid (the launch floor) at 128, 1,024 and 8,192 lanes.
Imports no JAX.
"""

import collections
import ctypes
import itertools
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gnina_tpu_torch import _fixtures as fx  # noqa: E402
from gnina_tpu_torch.chem.ingest import box_from_center_size  # noqa: E402
from gnina_tpu_torch.docking import DockSettings  # noqa: E402
from gnina_tpu_torch.ops import _cuda  # noqa: E402
from gnina_tpu_torch.ops import fused_dock as fd  # noqa: E402
from gnina_tpu_torch.scoring.builtin import get_scoring_function  # noqa: E402

NEW_ARGS = fd._pack_args


class _OldPackArgs(ctypes.Structure):
    _fields_ = [f for f in fd._PackArgs._fields_ if f[0] != "rec_tile"]


def _old_pack_args(pack, device):
    a, b = _OldPackArgs(), NEW_ARGS(pack, device)
    for f, _ in _OldPackArgs._fields_:
        setattr(a, f, getattr(b, f))
    return a


def split_spec(spec):
    """'PATH.cu:A=1,B=2' -> ('PATH.cu', ['-DA=1', '-DB=2'])."""
    path, _, defs = spec.partition(":")
    return path, [f"-D{d}" for d in defs.split(",") if d]


def compile_all(sources, verbose=False, prefix="ab"):
    """{source: shared library path}, one nvcc each, all started together
    (the definitions after a source's colon passed as -D); verbose prints
    ptxas' register and spill report."""
    out_dir = os.path.join(_cuda.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    flags = _cuda.NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    jobs = {}
    for i, src in enumerate(sources):
        path, defs = split_spec(src)
        so = os.path.join(out_dir, f"{prefix}{i}.so")
        jobs[src] = (so, subprocess.Popen(
            [_cuda._nvcc()] + flags + defs + ["-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for src, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{err}")
        if verbose:
            print(f"ptxas on {src}:\n" + "\n".join(
                ln for ln in err.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln),
                flush=True)
        out[src] = os.path.abspath(so)
    return out


class _NoLaneOffset:
    """A build of a source older than the MC windows' lane_offset argument
    (the ninth of gt_async_mc_window and gt_lockstep_mc_window): the calls
    drop it, and it must be 0."""

    MC = ("gt_async_mc_window", "gt_lockstep_mc_window")

    def __init__(self, lib):
        self._lib = lib
        for name in self.MC:
            fn = getattr(lib, name)
            fn.argtypes = fn.argtypes[:8] + fn.argtypes[9:]

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self.MC:
            return fn

        def call(*args):
            if args[8].value if hasattr(args[8], "value") else args[8]:
                raise ValueError(f"{name}: this build has no lane_offset")
            return fn(*(args[:8] + args[9:]))
        return call


def build(sources, verbose=False):
    """{source: (library, older argument block)} for builds of
    fused_dock.cu."""
    libs = {}
    for src, so in compile_all(sources, verbose).items():
        lib = ctypes.CDLL(so)
        _cuda._bind_fused(lib)
        with open(split_spec(src)[0]) as f:
            text = f.read()
        if "lane_offset" not in text:
            lib = _NoLaneOffset(lib)
        libs[src] = (lib, "rec_tile" not in text)
    return libs


def use(lib, old_abi):
    _cuda._LIBS["fused_dock"] = lib
    fd._pack_args = _old_pack_args if old_abi else NEW_ARGS


def system(box, cube, dev):
    rec, lig, center, size = fx.system(seed=0, box=box, cube=cube)
    sf = get_scoring_function("vina")
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=sf.cutoff)
    lo, hi = box_from_center_size(center, size)
    pack = fd.build_pack([lig] * 16, pruned.coords, pruned.types,
                         np.ones(len(pruned.types), np.float32), 8, sf.table,
                         m_pad=4, device=dev)
    return lig, pack, lo, hi, fd.extract_vina_terms(sf)


KERNELS = ("k_bfgs", "k_async_mc", "k_lockstep_mc", "k_eval_fg")
PROBE_KERNELS = ("k_probe_pairs", "k_probe_gather", "k_probe_mxu", "k_sum",
                 "k_empty")


def device_ms(fn, n, kernels=KERNELS):
    """Mean device time of the port's kernels a call over n calls, from
    torch.profiler's kernel records (one stream, so they add up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA
             and any(k in ev.name for k in kernels))
    return us / 1e3 / n


def timed(fn, n, kernels=KERNELS):
    """(median of n calls, each alone between two events and a
    synchronize, so that the host's time to make the call counts; mean of
    n calls made back to back between two events, where the host's work
    overlaps the card's; device_ms of n calls)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return float(np.median(ts)), a.elapsed_time(b) / n, \
        device_ms(fn, n, kernels)


def main_path(dev):
    """The main path's system, scalars and starts: {name: callable} for
    every timed row, given the kernels bound at call time."""
    lig, pack, lo, hi, terms = system(20.0, 40.0, dev)
    # one lane per saved pose, as the finish stages run them (L=800)
    num_out = max(DockSettings().num_modes, DockSettings().num_mc_saved)
    pack_out = pack.with_lanes(torch.arange(
        16, device=dev, dtype=torch.int32).repeat_interleave(num_out))
    scal_h = fd.scal_vector(10.0, 10.0, 1e3, 1000.0, lo, hi, 2.0, 1.2,
                            device=dev)
    scal_r = fd.scal_vector(1000.0, 1000.0, 1e3, 1000.0, lo, hi, device=dev)
    scal_s = fd.scal_vector(1000.0, 1000.0, 1e5, 1000.0, lo, hi, device=dev)
    miniters = max(int((25 + lig.num_atoms) / 3), 1)
    rng = np.random.default_rng(0)
    r, t = fx.packed_poses(rng, pack.lanes, lo, hi, lig, 4, dev, "random")
    rp, tp = fx.packed_poses(rng, pack.lanes, lo, hi, lig, 4, dev,
                             "perturbed")
    rf, tf = fx.packed_poses(rng, pack_out.lanes, lo, hi, lig, 4, dev,
                             "random")
    rf, tf = fd.bfgs_minimize(terms, rf, tf, scal_h, pack_out, miniters)[:2]
    rf, tf = fd.bfgs_minimize(terms, rf, tf, scal_r, pack_out, miniters)[:2]
    ecur = torch.full((pack.lanes,), 3.0e38, device=dev)
    rows = {
        "K3": (3, lambda: fd.async_mc_window(
            terms, r, t, scal_h, pack, ecur, 128, 16, miniters, seed=2)),
        "K6": (3, lambda: fd.async_mc_window(
            terms, r, t, scal_h, pack, ecur, 128, 16, miniters, seed=2,
            warm_ls=True))}
    for tag, frac in (("", 1.0), ("K8 ", 0.9)):
        for name, async_ls in (("K2", False), ("K4", True)):
            kw = dict(async_ls=async_ls, done_frac=frac)
            rows[f"{tag}{name} L=128"] = (10, lambda kw=kw: fd.bfgs_minimize(
                terms, rp, tp, scal_r, pack, miniters, True, **kw))
            rows[f"{tag}{name} L={pack_out.lanes}"] = (
                10, lambda kw=kw: fd.bfgs_minimize(
                    terms, rf, tf, scal_s, pack_out, miniters, False, **kw))
        rows[f"{tag}K5"] = (5, lambda frac=frac: fd.lockstep_mc_window(
            terms, r, t, scal_h, pack, ecur, 16, miniters, seed=2,
            done_frac=frac))
    rows["K1"] = (5, lambda: fd.eval_fg(terms, rp, tp, scal_r, pack))
    rows[f"K1 L={pack_out.lanes}"] = (5, lambda: fd.eval_fg(
        terms, rf, tf, scal_r, pack_out))
    return rows


def streamed(dev):
    lig, pack, lo, hi, terms = system(34.0, 60.0, dev)
    scal_h = fd.scal_vector(10.0, 10.0, 1e3, 1000.0, lo, hi, 2.0, 1.2,
                            device=dev)
    scal_r = fd.scal_vector(1000.0, 1000.0, 1e3, 1000.0, lo, hi, device=dev)
    miniters = max(int((25 + lig.num_atoms) / 3), 1)
    rng = np.random.default_rng(0)
    r, t = fx.packed_poses(rng, pack.lanes, lo, hi, lig, 4, dev, "random")
    ecur = torch.full((pack.lanes,), 3.0e38, device=dev)
    return pack.rec.shape[0], {
        "K3": (3, lambda: fd.async_mc_window(
            terms, r, t, scal_h, pack, ecur, 128, 16, miniters, seed=2)),
        "K1": (5, lambda: fd.eval_fg(terms, r, t, scal_r, pack))}


def value_only_is_exact(dev):
    """Whether K1's value-only evaluation (a null gradient output) gives the
    value+gradient evaluation's energies bit for bit, on the refine's and
    the finish's poses: what a lockstep trial evaluated with its gradient
    relies on."""
    lig, pack, lo, hi, terms = system(20.0, 40.0, dev)
    scal = fd.scal_vector(1000.0, 1000.0, 1e3, 1000.0, lo, hi, device=dev)
    ok = True
    for seed, kind in ((1, "random"), (2, "perturbed")):
        r, t = fx.packed_poses(np.random.default_rng(seed), pack.lanes, lo,
                               hi, lig, 4, dev, kind)
        e = torch.empty(pack.lanes, device=dev)
        em = torch.empty_like(e)
        coords = torch.empty((pack.lanes, pack.dims[0], 3), device=dev)
        pa, ta, made = fd._pack_args(pack, r.device), \
            fd._term_args(terms), ctypes.c_int(0)
        code = _cuda.lib().gt_eval_fg(
            fd._addr(pa), fd._addr(ta), fd._ptr(r), fd._ptr(t),
            fd._ptr(scal), fd._ptr(e), fd._ptr(em), fd._ptr(None),
            fd._ptr(coords), fd._stream(), ctypes.byref(made))
        got = fd.eval_fg(terms, r, t, scal, pack)
        torch.cuda.synchronize()
        ok = ok and code == 0 and torch.equal(e, got[0]) \
            and torch.equal(em, got[1])
    return ok


def build_probes(sources, verbose=False):
    """{source: (library, kind of entry points)} for builds of probes.cu:
    "old" (K9 and K10 size their own grids, then k_sum adds the partial
    sums), "plan" (they take the grid; k_sum as before) or "slots" (each
    probe one launch: its blocks' sums go to 8-byte slots tagged with the
    launch's number, and block 0 adds them)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for src, so in compile_all(sources, verbose, "abp").items():
        lib = ctypes.CDLL(so)
        with open(split_spec(src)[0]) as f:
            text = f.read()
        kind = ("old" if not hasattr(lib, "gt_probe_empty") else
                "slots" if "unsigned epoch" in text else "plan")
        if kind == "slots":
            _cuda._bind_probes(lib)
        else:
            lib.gt_probe_pairs.argtypes = [vp] * 4 + [ci] * (
                5 if kind == "old" else 9) + [vp] * 3
            lib.gt_probe_gather.argtypes = [vp, vp, vp, ci, ci] + [ci] * (
                kind == "plan") + [vp] * 3
            lib.gt_probe_mxu.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
        libs[src] = (lib, kind)
    return libs


def probe_rows(lib, kind, x, reps):
    """{row: (calls, callable)} for one build of probes.cu, each through
    its C entry point with buffers made once: the same host path for every
    build."""
    from gnina_tpu_torch import probes

    _cuda._LIBS["probes"] = lib
    p = probes._p
    dev = x["lig"].device
    lanes, n, k = x["lig"].shape[1], x["ligp"].shape[1], x["rec"].shape[0]
    a = n * lanes
    pl = probes.pairs_plan(lanes, n, k)
    gp = probes.gather_plan(a, reps)
    # the older entry points size their own grids
    pair_grid = () if kind == "old" else (*pl["grid"], pl["atoms"])
    gather_grid = () if kind == "old" else (gp["blocks"],)
    part = torch.empty(max(lanes, a, pl["blocks"], gp["blocks"]), device=dev)
    out = torch.empty(1, device=dev)
    if kind == "slots":
        slots = torch.zeros(part.numel(), dtype=torch.int64, device=dev)
        epoch = itertools.count(1)
        tail = lambda: (p(slots), next(epoch), p(out))  # noqa: E731
    else:
        tail = lambda: (p(part), p(out))  # noqa: E731

    def pairs(bf16):
        return lambda: lib.gt_probe_pairs(
            p(x["lig"]), p(x["ligp"]), p(x["rec"]), p(x["recp"]), lanes, n,
            k, reps, bf16, *pair_grid, *tail(), probes._stream())

    return {
        "K9 f32": (10, pairs(0)), "K9 bf16": (10, pairs(1)),
        "K10": (20, lambda: lib.gt_probe_gather(
            p(x["idx"]), p(x["cells"]), p(x["w"]), a, reps, *gather_grid,
            *tail(), probes._stream())),
        "K11": (10, lambda: lib.gt_probe_mxu(
            p(x["tgt"]), p(x["g"]), a, x["g"].shape[0], reps, *tail(),
            probes._stream()))}


def main_probes(sources, verbose):
    """The probes of each build of probes.cu in turns, then K10's floor and
    K10 at larger lane counts for the last build."""
    from gnina_tpu_torch import probes

    dev = torch.device("cuda")
    libs = build_probes(sources, verbose)
    reps = 20
    x = probes.make_inputs(0, 128, 32, 1280, dev)
    got = collections.defaultdict(list)
    names = ("K9 f32", "K9 bf16", "K10", "K11")
    for src in sources:
        for name, (_, fn) in probe_rows(*libs[src], x, reps).items():
            code = fn()
            if isinstance(code, int) and code:
                sys.exit(f"{src} {name}: CUDA error {code}")
    for src in sources + sources[::-1]:
        rows = probe_rows(*libs[src], x, reps)
        parts = []
        for name in names:
            n_calls, fn = rows[name]
            res = timed(fn, n_calls, PROBE_KERNELS)
            for mode, v in zip(((), ("b2b",), ("device",)), res):
                got[(src, name) + mode].append(v)
            parts.append(f"{name} {res[0]:.4f} / {res[1]:.4f} / "
                         f"{res[2]:.4f}")
        print(f"{src}: " + ", ".join(parts) + " (ms, alone / back to back "
              "/ device)", flush=True)
    for mode, title in (((), "a call alone"), (("b2b",), "back to back"),
                        (("device",), "the kernels on the card")):
        print(f"median over the turns (ms, {title}):")
        for name in names:
            print(name.ljust(10) + "".join(
                f"{np.median(got[(s, name) + mode]):.4f}".rjust(12)
                for s in sources) + "   " + " / ".join(sources))
    lib, kind = libs[sources[-1]]
    _cuda._LIBS["probes"] = lib
    if kind == "slots":         # the package's own entry points
        for lanes in (128, 1024, 8192):
            xl = probes.make_inputs(0, lanes, 32, 16, dev)
            a = 32 * lanes
            plan = probes.gather_plan(a, reps)
            k10 = timed(lambda: probes.probe_gather_loop(
                xl["idx"], xl["cells"], xl["w"], reps), 20, PROBE_KERNELS)
            floor = timed(lambda: probes.launch_empty(
                plan["blocks"], plan["threads"]), 20, PROBE_KERNELS)
            print(f"K10 L={lanes} ({a} lookups x {reps} reps, "
                  f"{plan['blocks']} blocks): on the card {k10[2]:.4f} ms, "
                  f"the empty kernel on the same grid {floor[2]:.4f} ms; "
                  f"{1e6 * (k10[2] - floor[2]) / (a * reps):.4f} ns a "
                  f"lookup above the floor; alone {k10[0]:.4f} / "
                  f"{floor[0]:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


def main(sources, verbose):
    dev = torch.device("cuda")
    libs = build(sources, verbose)
    for src in sources:
        with open(split_spec(src)[0]) as f:
            if "if (out_g)" in f.read():    # K1 has a value-only mode
                use(*libs[src])
                print(f"{src}: value-only energies bit-equal to the "
                      f"value+gradient ones: {value_only_is_exact(dev)}",
                      flush=True)
    use(*libs[sources[-1]])
    rows = main_path(dev)
    got = collections.defaultdict(list)
    for src in sources + sources[::-1]:
        use(*libs[src])
        parts = []
        for name, (reps, fn) in rows.items():
            one, b2b, on_card = timed(fn, reps)
            got[(src, name)].append(one)
            got[(src, name, "b2b")].append(b2b)
            got[(src, name, "device")].append(on_card)
            parts.append(f"{name} {one:.3f} / {b2b:.3f} / {on_card:.3f}")
        print(f"K=2157 {src}: " + ", ".join(parts) + " (ms, alone / back "
              "to back / device)", flush=True)
    k, big = streamed(dev)
    use(*libs[sources[-1]])
    print(f"K={k} {sources[-1]}: " + ", ".join(
        f"{name} {timed(fn, reps)[0]:.3f}" for name, (reps, fn) in
        big.items()) + " (ms)", flush=True)
    for mode, title in (((), "a call alone"), (("b2b",), "back to back"),
                        (("device",), "the kernels on the card")):
        print(f"median over the turns (ms, {title}):")
        print("row".ljust(14) + "".join(
            os.path.basename(s).rjust(max(16, len(os.path.basename(s)) + 2))
            for s in sources))
        for name in rows:
            print(name.ljust(14) + "".join(
                f"{np.median(got[(s, name) + mode]):.3f}".rjust(
                    max(16, len(os.path.basename(s)) + 2))
                for s in sources))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    argv = [a for a in sys.argv[1:] if a not in ("-v", "--probes")]
    if not argv or not torch.cuda.is_available():
        sys.exit(__doc__)
    (main_probes if "--probes" in sys.argv[1:] else main)(
        argv, "-v" in sys.argv[1:])
