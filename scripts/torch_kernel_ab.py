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
          miniters, Philox)
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
the turns.  Imports no JAX.
"""

import collections
import ctypes
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


def build(sources, verbose=False):
    """{source: (library, older argument block)}, all nvcc started
    together; verbose prints ptxas' register and spill report."""
    out_dir = os.path.join(_cuda.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    flags = _cuda.NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    jobs = {}
    for i, src in enumerate(sources):
        path, defs = split_spec(src)
        so = os.path.join(out_dir, f"ab{i}.so")
        jobs[src] = (so, subprocess.Popen(
            [_cuda._nvcc()] + flags + defs + ["-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for src, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{err}")
        if verbose:
            print(f"ptxas on {src}:\n" + "\n".join(
                ln for ln in err.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln),
                flush=True)
        lib = ctypes.CDLL(os.path.abspath(so))
        _cuda._bind_fused(lib)
        with open(split_spec(src)[0]) as f:
            libs[src] = (lib, "rec_tile" not in f.read())
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


def device_ms(fn, n):
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
             and any(k in ev.name for k in KERNELS))
    return us / 1e3 / n


def timed(fn, n):
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
    return float(np.median(ts)), a.elapsed_time(b) / n, device_ms(fn, n)


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
            terms, r, t, scal_h, pack, ecur, 128, 16, miniters, seed=2))}
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
    argv = [a for a in sys.argv[1:] if a != "-v"]
    if not argv or not torch.cuda.is_available():
        sys.exit(__doc__)
    main(argv, "-v" in sys.argv[1:])
