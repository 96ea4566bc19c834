#!/usr/bin/env python3
"""A cell on several cards: one process a card, each a rank of the
renderer's mesh (rayn_tpu_torch.parallel.sharding), as the command
line's `--multichip-mode rays` runs a frame.

`launch` (harness.run, for a cell whose `chips` is above 1) builds the
renderer's kernels once, so that no two ranks race on the build
directory, then starts this file once a rank and waits. A rank that
exits non-zero ends the run at once: the launcher kills the other
ranks, which may be waiting for it in a collective, and exits non-zero
with no result. Otherwise it passes on the ranks' standard error, rank
0's last, and prints rank 0's result line.

A rank (`main`) joins the group with `parallel.distributed.init` (NCCL
on the cards, gloo on the CPU) and a second, gloo group for control,
which runs no kernel on a card, so a card's trace holds the renderer's
collectives only. Every rank renders each frame's slice through
`render_frame(mesh=...)` (harness.run_frames). Rank 0 alone resolves the
film and keeps the clock: before each frame it tells every rank over the
control group whether the frame comes, so all render the same frames.
After the window the ranks send rank 0 their peak memory and, traced,
their reduced traces, and rank 0 checks its resolved frames and prints
the result.
"""

import argparse
import ctypes
import dataclasses
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

CODE = Path(__file__).resolve().parent.parent
# the longest a rank may run: a first run's window, trace and check
LIMIT_S = 1200.0
TAIL = 4000   # characters of a failed rank's standard error passed on


@dataclasses.dataclass
class Ranks:
    """This process's place among the ranks of a run."""
    rank: int
    size: int
    mesh: object   # sharding.Mesh over the world group
    ctl: object    # the gloo group that carries rank 0's word

    def agree(self, more: bool) -> bool:
        """Rank 0's `more` on every rank (one gloo broadcast)."""
        word = torch.tensor([int(more)], dtype=torch.int32)
        dist.broadcast(word, src=0, group=self.ctl)
        return bool(word.item())


# ---- the launcher -----------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_command(rank: int, size: int, port: int, cell, seed: int,
                 seconds: float, trace: bool, t0: float, root: Path,
                 device: str) -> list[str]:
    """The command line of one rank's process. `t0` is the launcher's
    start on time.perf_counter, which on Linux is the system-wide
    monotonic clock, so a rank's set-up counts from it."""
    return [sys.executable, str(CODE / "benchmark" / "multirank.py"),
            "--workload", cell.name, "--seed", str(seed),
            "--seconds", repr(float(seconds)), "--trace", str(int(trace)),
            "--rank", str(rank), "--size", str(size), "--port", str(port),
            "--t0", repr(t0), "--root", str(root), "--device", device,
            "--parent", str(os.getpid())]


def launch(cell, seed: int, seconds: float, trace: bool, t0: float,
           root: Path, device: str) -> int:
    """Run the cell's ranks; print rank 0's result line. The exit code is
    0 only if every rank exited 0."""
    from benchmark import harness
    if device == "cuda":
        from rayn_tpu_torch import _build
        _build.library_path()   # build here, before any rank loads it
    size, port = cell.chips, free_port()
    log = sys.stderr
    # ended from outside: the finally below still stops the ranks
    old = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        with tempfile.TemporaryDirectory() as logs:
            outs = [Path(logs, f"{r}.out") for r in range(size)]
            errs = [Path(logs, f"{r}.err") for r in range(size)]
            procs = []
            try:
                for r in range(size):
                    with open(outs[r], "w") as o, open(errs[r], "w") as e:
                        procs.append(subprocess.Popen(
                            rank_command(r, size, port, cell, seed, seconds,
                                         trace, t0, root, device),
                            stdout=o, stderr=e,
                            env=dict(os.environ, LOCAL_RANK=str(r))))
                deadline = time.monotonic() + LIMIT_S
                while time.monotonic() < deadline:
                    codes = [p.poll() for p in procs]
                    if any(codes) or all(c == 0 for c in codes):
                        break
                    time.sleep(0.05)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
            codes = [p.returncode for p in procs]
            err_text = [e.read_text(errors="replace") for e in errs]
            result = outs[0].read_text().strip().splitlines()
    finally:
        signal.signal(signal.SIGTERM, old)
    if any(codes):
        for r, c in enumerate(codes):
            if c:
                print(f"multirank: rank {r} exited {c}"
                      + (" (stopped by the launcher)" if c < 0 else ""),
                      file=log)
        for r, c in enumerate(codes):
            if c and c > 0 or r == 0:
                print(f"--- rank {r}, standard error (end) ---\n"
                      + err_text[r][-TAIL:], file=log)
        return 1
    bad = harness.forbidden_modules()
    if bad or not result:
        print(f"multirank: forbidden modules loaded: {bad}" if bad else
              "multirank: rank 0 printed no result", file=log)
        return 3
    for r in range(1, size):
        log.write(err_text[r])
    log.write(err_text[0])
    log.flush()
    print(result[-1], flush=True)
    return 0


# ---- a rank -----------------------------------------------------------

def die_with_parent(parent: int) -> None:
    """Have the kernel kill this rank if the launcher dies (Linux), so no
    rank outlives a launcher that was killed."""
    try:
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name, kind in (("workload", str), ("seed", int), ("seconds", float),
                       ("trace", int), ("rank", int), ("size", int),
                       ("port", int), ("t0", float), ("root", str),
                       ("device", str), ("parent", int)):
        ap.add_argument("--" + name, type=kind, required=True)
    args = ap.parse_args(argv)
    die_with_parent(args.parent)
    from benchmark import harness
    from rayn_tpu_torch.parallel import distributed, sharding

    cell = harness.load_cell(args.workload, Path(args.root))
    distributed.init(f"localhost:{args.port}", args.size, args.rank,
                     device=args.device)
    ctl = dist.new_group(backend="gloo")
    ranks = Ranks(args.rank, args.size,
                  sharding.make_mesh(device=None if args.device == "cuda"
                                     else args.device), ctl)
    mods = harness.metric_modules(cell) if args.rank == 0 else None
    rec = harness.run_frames(cell, args.seed, args.seconds,
                             bool(args.trace), args.device, args.t0, ranks)
    got = [None] * args.size if args.rank == 0 else None
    dist.gather_object(dict(peak=rec["peak"], traced=rec["traced"]), got,
                       dst=0, group=ctl)
    dist.destroy_process_group()
    if args.rank == 0:
        rec["peak"] = max(g["peak"] for g in got)
        if args.trace:
            rec["rank_traces"] = [g["traced"] for g in got]
        return harness.report(cell, rec, args.seed, bool(args.trace),
                              args.device, mods)
    print(f"rank {args.rank}: setup_s {rec['setup_s']:.3f}, "
          f"{len(rec['frames'])} frames, peak {rec['peak']} bytes",
          file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"rank {args.rank}: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    return 0


def entry(argv=None) -> None:
    """A rank's process: `main`, then exit at once with its code, or with
    1 and the traceback if it raised, whatever threads its collectives
    left behind."""
    try:
        code = main(argv)
    except Exception:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    sys.path[0] = str(CODE)   # not benchmark/: its modules are a package
    entry()
