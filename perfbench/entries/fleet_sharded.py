"""The node-sharded fleet engine's cells: ``repro_torch.
seeker_fleet_simulate_sharded`` on the configuration's ("pod", "data")
mesh, one process a card, driven in steps as the ``fleet`` entry drives the
single-device engine (:class:`FleetCell`, whose inputs, check and metrics
this entry keeps).

The harness's process is rank 0 on ``cuda:0``.  Set-up starts ranks 1 to
W - 1 as processes of this file on ``cuda:1`` and up::

    python3 -P perfbench/entries/fleet_sharded.py RANK ARGS_JSON

each pinned to cores of its own where the machine has twice as many cores
as ranks.  Every rank draws the cell's inputs from the seed on its own
card, joins an NCCL group (gloo on the CPU) through a ``FileStore`` in a
temporary directory, and takes rank 0's inputs by broadcast, so that every
rank holds the same whole-fleet pool.  Each of rank 0's steps writes one
byte to each other rank's standard input (``s``); every rank then calls the
sharded engine with the whole fleet's keys, state and brown-out flags from
the last step, as SPMD asks, and ends in ``torch.cuda.synchronize()``.
While rank 0's profiler records, the other ranks run under one too (``p``
starts it and is acknowledged on their standard output, ``q`` stops it;
their traces are discarded), so that no rank runs slower than the rest for
being the one traced.  ``x`` or the end of the input ends a rank.

Only rank 0 keeps the sampled nodes' steps and holds them to the reference
(every rank returns the whole fleet's result).  A rank that exits before
rank 0 releases the cell ends rank 0 at once with a nonzero code, the ranks
end with rank 0 (``PR_SET_PDEATHSIG``), and the group's collectives time
out after :data:`GROUP_TIMEOUT_S`.
"""
from __future__ import annotations

import datetime
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench.harness import (Cell, Context, forbidden_modules,  # noqa: E402
                               load_module)

FleetCell = load_module(HERE.parent / "fleet.py",
                        "perfbench_entry_fleet").FleetCell

GROUP_TIMEOUT_S = 120
WATCH_S = 0.2


def _core_sets(world: int) -> list | None:
    """Disjoint sets of this process's cores, one a rank, or None where
    there are fewer than two a rank."""
    cores = sorted(os.sched_getaffinity(0))
    per = len(cores) // world
    if per < 2:
        return None
    return [cores[r * per:(r + 1) * per] for r in range(world)]


def _give_up(why: str) -> None:
    """End this process at once with a nonzero code (its other ranks end
    with it)."""
    print(f"perfbench: {why}; ending the run", file=sys.stderr, flush=True)
    os._exit(1)


def _collective_bytes() -> int | None:
    """Bytes of the program's collectives so far in this process, or None
    where the program does not count them."""
    from repro_torch import sharding
    counts = getattr(sharding, "collective_counts", None)
    return None if counts is None else sum(
        c["bytes"] for c in counts().values())


class ShardedFleetCell(FleetCell):
    def __init__(self, ctx, rank: int = 0, store: str | None = None):
        dims = ctx.config["mesh"]
        self.world, self.rank = math.prod(dims.values()), rank
        self.children = []
        self.profiler, self.profiling = None, False
        self.closing, self.store_dir = False, None
        self.bytes_at = []
        cuda = ctx.device.type == "cuda"
        if cuda:
            torch.cuda.set_device(ctx.device)
        if rank == 0:
            # the ranks share the host's cores: no more threads a rank than
            # its share (the card's harness asks for fewer)
            self.threads = torch.get_num_threads()
            torch.set_num_threads(min(self.threads, max(
                1, len(os.sched_getaffinity(0)) // self.world)))
            self.store_dir = tempfile.mkdtemp(prefix="perfbench-sharded-")
            store = os.path.join(self.store_dir, "store")
            cores = _core_sets(self.world) if cuda else None
            self._spawn(ctx, store, cores)
            if cores:
                os.sched_setaffinity(0, cores[0])
                print(f"perfbench: {self.world} ranks pinned to "
                      f"{len(cores[0])} cores each of "
                      f"{sum(map(len, cores))}", file=sys.stderr)
        super().__init__(ctx)
        self._join(ctx, dims, store, cuda)

    # --- the group -----------------------------------------------------------

    def _spawn(self, ctx, store: str, cores) -> None:
        args = json.dumps({
            "name": ctx.cell.name, "entry": ctx.cell.entry,
            "spec": ctx.spec, "config": ctx.config, "mix": ctx.mix,
            "seed": ctx.seed, "nodes": ctx.nodes, "device": ctx.device.type,
            "threads": torch.get_num_threads(), "store": store,
            "cores": cores, "parent": os.getpid()})
        for r in range(1, self.world):
            p = subprocess.Popen([sys.executable, "-P", str(HERE), str(r),
                                  args], stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, cwd=ROOT)
            self.children.append(p)
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        """End rank 0 as soon as another rank exits before release."""
        while not self.closing:
            for r, p in enumerate(self.children, 1):
                code = p.poll()
                if code is not None and not self.closing:
                    _give_up(f"rank {r} exited with {code}")
            time.sleep(WATCH_S)

    def _join(self, ctx, dims: dict, store: str, cuda: bool) -> None:
        """The process group, the mesh, and rank 0's inputs on every
        rank."""
        import torch.distributed as dist
        from repro_torch.sharding import make_mesh

        extra = {"device_id": ctx.device} if cuda else {}
        dist.init_process_group(
            ctx.config["backend"] if cuda else "gloo",
            store=dist.FileStore(store, self.world), rank=self.rank,
            world_size=self.world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **extra)
        self.mesh = make_mesh(tuple(dims.values()), tuple(dims),
                              device_type=ctx.device.type)
        for t in (self.windows, self.harvest, self.signatures, self.keys0,
                  *self.weights.values(), *self.gen):
            buf = t.contiguous()
            dist.broadcast(buf, src=0)
            if buf is not t:
                t.copy_(buf)

    def _tell(self, cmd: bytes) -> None:
        for p in self.children:
            p.stdin.write(cmd)
            p.stdin.flush()

    def _follow_profiler(self) -> None:
        """Start or stop the other ranks' profilers to match rank 0's; a
        start is acknowledged before the step, so that it is not timed."""
        on = torch.autograd.profiler._is_profiler_enabled
        if on == self.profiling:
            return
        self._tell(b"p" if on else b"q")
        if on:
            for p in self.children:
                if p.stdout.read(1) != b"p":
                    raise RuntimeError("a rank did not start its profiler")
        self.profiling = on

    def _profile(self, on: bool) -> None:
        """This rank's own profiler, started or stopped and discarded."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.obs import trace
        if on:
            acts = [ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.profiler = profile(activities=acts)
            self.profiler.__enter__()
        elif self.profiler is not None:
            self.profiler.__exit__(None, None, None)
            self.profiler = None
            trace.clear()

    def serve(self, commands, acks) -> None:
        """A rank other than 0: run rank 0's commands until ``x`` or the
        end of its input."""
        while True:
            cmd = commands.read(1)
            if cmd == b"s":
                self.step()
            elif cmd == b"p":
                self._profile(True)
                acks.write(b"p")
                acks.flush()
            elif cmd == b"q":
                self._profile(False)
            else:
                break
        self._profile(False)

    # --- the timed path ------------------------------------------------------

    def step(self) -> None:
        import repro_torch
        if self.children:
            self._follow_profiler()
            self._tell(b"s")
        s0 = (self.steps * self.s) % self.pool
        res = repro_torch.seeker_fleet_simulate_sharded(
            self.windows[:, s0:s0 + self.s], self.harvest[:, s0:s0 + self.s],
            mesh=self.mesh,
            node_keys=self.keys0 if self.keys is None else self.keys,
            state0=self.state, brownout_state0=self.browned, **self.kwargs)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.state, self.keys = res["final_state"], res["final_keys"]
        self.browned = res["final_brownout"]
        self.steps += 1
        if self.rank == 0:
            self._keep(res)
            self.bytes_at.append(_collective_bytes())

    # --- what the metrics read -----------------------------------------------

    def layer_span(self) -> str:
        return "serving.fleet.seeker_fleet_simulate_sharded"

    def collective_bytes_per_slot(self, first: int, steps: int):
        """Rank 0's collective bytes a slot over steps ``[first, first +
        steps)``; None where the program does not count them."""
        at = self.bytes_at
        if (first < 1 or steps < 1 or first + steps > len(at)
                or at[first - 1] is None):
            return None
        return (at[first + steps - 1] - at[first - 1]) / (steps * self.s)

    def release(self) -> None:
        """Stop the other ranks and leave the group, before the reference
        runs on rank 0.  Every rank leaves at once (NCCL's teardown waits
        for the whole group); a rank 0 not done within
        :data:`GROUP_TIMEOUT_S` ends with a nonzero code."""
        import torch.distributed as dist
        super().release()
        self.closing = True
        deadline = None
        if self.rank == 0:
            deadline = threading.Timer(GROUP_TIMEOUT_S, _give_up,
                                       ("the ranks did not leave the group",))
            deadline.daemon = True
            deadline.start()
        for p in self.children:
            try:
                p.stdin.write(b"x")
                p.stdin.close()
            except OSError:
                pass
        if dist.is_initialized():
            dist.destroy_process_group()
        codes = [p.wait() for p in self.children]
        self.children = []
        if deadline is not None:
            deadline.cancel()
            shutil.rmtree(self.store_dir, ignore_errors=True)
            torch.set_num_threads(self.threads)
        if any(codes):
            raise RuntimeError(f"ranks 1.. exited with {codes}")


def setup(ctx):
    return ShardedFleetCell(ctx)


def _rank_main(rank: int, args: dict) -> int:
    """Ranks 1 to W - 1."""
    import ctypes
    try:   # end with rank 0, whatever ends it
        prctl = ctypes.CDLL(None).prctl
        prctl.argtypes = [ctypes.c_int, ctypes.c_ulong]
        prctl.restype = ctypes.c_int
        prctl(1, signal.SIGKILL)                          # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != args["parent"]:
        return 1
    acks = os.fdopen(os.dup(1), "wb", buffering=0)
    os.dup2(2, 1)                  # standard output belongs to rank 0
    torch.set_num_threads(args["threads"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = (torch.device("cuda", rank) if args["device"] == "cuda"
           else torch.device("cpu"))
    cell = Cell(name=args["name"], bench={}, entry=args["entry"],
                spec=args["spec"], config=args["config"], mix=args["mix"],
                limits=args["spec"]["limits"])
    sut = ShardedFleetCell(Context(cell, args["seed"], dev, args["nodes"]),
                           rank=rank, store=args["store"])
    sut.serve(sys.stdin.buffer, acks)
    sut.release()
    found = forbidden_modules()
    if found:
        print(f"perfbench: rank {rank} loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    _args = json.loads(sys.argv[2])
    if _args["cores"]:
        os.sched_setaffinity(0, _args["cores"][int(sys.argv[1])])
    sys.exit(_rank_main(int(sys.argv[1]), _args))
