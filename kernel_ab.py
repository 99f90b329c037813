#!/usr/bin/env python3
"""Compare two builds of the msl_cache kernels on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 kernel_ab.py [--base DIR] [--source LABEL=FILE ...] [--sass-only]
                         [--dump DIR]

``--base DIR`` names the root of another checkout (for example the parent
commit, unpacked with ``git archive`` into a gitignored directory).  Each
checkout's ``src/repro_torch/kernels/csrc/msl_cache.cu`` is built with the
port's nvcc flags (``kernels/build.py``) and loaded with ctypes.  For each
build the script prints the registers (from ``ptxas.log``) and the static
SASS instruction count, NOPs left out (from ``cuobjdump -sass``), of the
main geometry's kernel instances (C = 3, KP = 1; for the access kernel the
instances of the lane-group widths of the timed geometries, W = 8 at
A = 8 and W = 32 at A = 32, where the kernel has a width parameter);
``--dump DIR`` also writes their SASS there.  ``--source LABEL=FILE`` adds
another variant of ``msl_cache.cu`` (same C interface).  Without
``--sass-only`` it then times the builds in turns (base, this, variants,
then the same in reverse), each through the port's own wrappers on the
same inputs, after checking each against the plain version bit for bit:

* ``msl_access`` at ``chip_smoke.py`` phase 6's shapes (B = 8192 rows of the
  main configuration, A = 8, C = 3, gathered from a table warmed on the
  Zipf stream, ACCESS only), at B = 1 (the first of those rows), and on
  8192 random rows of an A = 32 geometry (m = 8, p = 4, C = 3);
* ``msl_onepass`` on phase 4's last main-configuration batch, and its ns
  per dependent transition and per member of a one-key run (phase 6's
  chains).

Without ``--base`` or ``--source`` only this checkout's build is read and
timed.  Times are device times from the profiler
(``chip_smoke.kernel_ms``); ``floor_ms`` is the device time of a one-word
``fill_``, the least a launch shows there.  The last line is one JSON
object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = Path("src/repro_torch/kernels/csrc/msl_cache.cu")


def instance(kernel, c, kp, w=None):
    """A regex for the mangled name of ``kernel<c, kp[, w]>``: a kernel
    templated on the lane-group width matches only width ``w``, one that is
    not matches whatever ``w``."""
    width = f"(?:Li{w}E)?" if w else ""
    return rf"{kernel}ILi{c}ELi{kp}E{width}E"


def cuobjdump():
    for path in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if path and Path(path).exists():
            return path
    raise RuntimeError("cuobjdump not found")


def sass_functions(lib):
    """{mangled kernel name: its SASS instruction lines} of a library."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            funcs[name].append(line.strip())
    return funcs


def read_build(label, source, pattern_args, dump):
    """Build ``source``; registers and SASS counts of the main instances."""
    import chip_smoke as cs
    from repro_torch.kernels.build import build_library

    lib = build_library(source)
    regs = cs.ptxas_registers(lib)
    funcs = sass_functions(lib)
    out = {"library": str(lib.relative_to(ROOT)), "kernels": {}}
    for kernel, w in pattern_args:
        key = f"{kernel}_w{w}" if w else kernel
        pat = re.compile(instance(kernel, 3, 1, w))
        names = [n for n in funcs if pat.search(n)]
        if len(names) != 1:
            raise AssertionError(f"{label}: {len(names)} instances match {pat.pattern}")
        lines = funcs[names[0]]
        body = [ln for ln in lines if not re.search(r"\bNOP\b", ln)]
        out["kernels"][key] = {"instance": names[0], "registers": regs[names[0]],
                                  "sass_instructions": len(body)}
        print(f"{label}: {key} ({names[0]}): {regs[names[0]]} registers, "
              f"{len(body)} SASS instructions ({len(lines)} with NOPs)", flush=True)
        if dump:
            Path(dump).mkdir(parents=True, exist_ok=True)
            (Path(dump) / f"sass_{label}_{key}.txt").write_text("\n".join(lines) + "\n")
    return lib, out


def main_inputs(torch):
    """Phase 4's inputs: the main configuration's table warmed on
    ``WARM_BATCHES`` batches of the Zipf stream, then its last compared
    batch's one-pass operands and the rows the rounds engine gathers for
    it.  Returns (cfg, keys, one-pass inputs, access operands)."""
    import chip_smoke as cs
    from repro_torch.core import MSLRUConfig, MultiStepLRUCache, set_index_for
    from repro_torch.data.ycsb import zipfian_tensor

    cfg = MSLRUConfig(num_sets=cs.MAIN_SETS, m=2, p=4, key_planes=1, value_planes=2)
    n_queries = 2 * cfg.capacity + cs.CHECK_BATCHES * cs.BATCH
    keys = zipfian_tensor(cs.N_KEYS, n_queries, cs.ZIPF_ALPHA, seed=cs.SEED,
                          device=cs.DEVICE)
    vals = torch.stack([keys, -keys], dim=1)
    warm = MultiStepLRUCache(cfg, device=cs.DEVICE)
    for i in range(cs.WARM_BATCHES + 4):
        q = slice(i * cs.BATCH, (i + 1) * cs.BATCH)
        if i >= cs.WARM_BATCHES:
            qk = keys[q, None]
            x = cs.onepass_case(torch, cfg, warm._padded, qk, vals[q])
            access = (warm.table[set_index_for(cfg, qk).long()], qk, vals[q])
        warm.access(keys[q], vals[q])
    return cfg, keys, x, tuple(t.contiguous() for t in access)


def measure(torch, cfg, keys, x, access, cfg32, access32):
    """One build's times (the wrappers use whichever library is bound)."""
    import chip_smoke as cs
    from repro_torch.kernels.msl_cache import (msl_access_kernel_call,
                                               msl_onepass_kernel_call)

    def access_ms(args, c):
        return cs.kernel_ms(torch, lambda: msl_access_kernel_call(*args, cfg=c), 200,
                            "msl_access_kernel")

    return {
        "access_ms": access_ms(access, cfg),
        "access_b1_ms": access_ms(tuple(t[:1].contiguous() for t in access), cfg),
        "access_a32_ms": access_ms(access32, cfg32),
        "onepass_ms": cs.kernel_ms(
            torch, lambda: msl_onepass_kernel_call(*x.kernel_args(), cfg=cfg), 50,
            "msl_onepass_kernel"),
        "chain_step_ns": cs.chain_step_ns(torch, cfg, keys),
        "run_member_ns": cs.run_member_ns(torch, cfg),
    }


def check(torch, cfg, x, access, cfg32, access32):
    """Each kernel against its plain version on the timed inputs."""
    import chip_smoke as cs
    from repro_torch.kernels.msl_cache import (chain_resolve_plain,
                                               msl_access_kernel_call,
                                               msl_access_plain,
                                               msl_onepass_kernel_call)

    worst = 0
    for args, c in ((access, cfg), (tuple(t[:1].contiguous() for t in access), cfg),
                    (access32, cfg32)):
        worst = max(worst, cs.max_abs_err(torch, msl_access_plain(*args, cfg=c),
                                          msl_access_kernel_call(*args, cfg=c)))
    worst = max(worst, cs.max_abs_err(torch, chain_resolve_plain(*x.kernel_args(), cfg=cfg),
                                      msl_onepass_kernel_call(*x.kernel_args(), cfg=cfg)))
    if worst:
        raise AssertionError(f"a kernel differs from its plain version: max |err| {worst}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, help="root of the checkout to compare with")
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=FILE: another variant of msl_cache.cu")
    ap.add_argument("--sass-only", action="store_true")
    ap.add_argument("--dump", help="directory for the instances' SASS")
    args = ap.parse_args()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    builds = {}
    patterns = [("msl_access_kernel", 8), ("msl_access_kernel", 32),
                ("msl_onepass_kernel", None)]
    if args.base:
        builds["base"] = read_build("base", args.base / CSRC, patterns, args.dump)
    builds["this"] = read_build("this", ROOT / CSRC, patterns, args.dump)
    for spec in args.source:
        label, path = spec.split("=", 1)
        builds[label] = read_build(label, Path(path).resolve(), patterns, args.dump)
    result = {"card": smi, "builds": {k: v[1] for k, v in builds.items()}}

    if not args.sass_only:
        import torch

        import chip_smoke as cs
        from repro_torch.core import MSLRUConfig
        from repro_torch.kernels import msl_cache

        cfg, keys, x, access = main_inputs(torch)
        cfg32 = MSLRUConfig(num_sets=64, m=8, p=4, key_planes=1, value_planes=2)
        gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
        access32 = cs.random_rows_case(torch, cfg32, cs.BATCH, gen)[:3]
        libs = {k: msl_cache._bind(ctypes.CDLL(str(ROOT / v[1]["library"])))
                for k, v in builds.items()}
        order = list(libs) + list(libs)[::-1]
        fill = torch.zeros(1, dtype=torch.int32, device=cs.DEVICE)
        result["floor_ms"] = cs.kernel_ms(torch, lambda: fill.fill_(1), 200, "Fill")
        print(f"floor: {result['floor_ms']:.5f} ms per one-word fill_", flush=True)
        turns = []
        for label in order:
            msl_cache._library = lambda lib=libs[label]: lib
            if label not in [t["build"] for t in turns]:
                check(torch, cfg, x, access, cfg32, access32)
            turns.append({"build": label, **measure(torch, cfg, keys, x, access,
                                                    cfg32, access32)})
            print(json.dumps(turns[-1]), flush=True)
        result["turns"] = turns
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
