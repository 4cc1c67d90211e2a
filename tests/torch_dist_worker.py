"""Rank worker of the port's multi-device tier, and the launcher that
starts one process per rank: the CPU tests run it over gloo, and
chip_smoke.py runs it on the card (NCCL, or gloo with host staging).

A worker joins a process group through INIT_URL (the tests use a
file:// rendezvous, so concurrent test workers never race for a port),
runs every case of a JSON job on DEVICE, and writes each case's results
as <out>/<case>.r<rank>.npz, with the seconds the case took, the
kernels' launches in it (the counts are zeroed before each case) and
the bytes the process has passed to write calls so far (io_wchar).
A case marked expect_error records the error it raises; any other error
ends the rank, so that its peers fail fast instead of waiting in a
collective.

    python tests/torch_dist_worker.py RANK N INIT_URL JOB.json OUT_DIR [DEVICE [BACKEND]]

DEVICE defaults to cpu and BACKEND to gloo. It imports torch, the
port and tests/torch_ooc_worker.py only, never jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = str(Path(__file__).resolve().parent.parent / "src")


# ---------------------------------------------------------------------------
# launcher (the test process, or chip_smoke.py)
# ---------------------------------------------------------------------------


class Batch:
    """N rank processes running one job; wait() or results() waits for
    them."""

    def __init__(self, out: Path, n: int, cases: list, timeout: float,
                 device: str, backend: str, env: dict):
        self.out, self.n, self.timeout = out, n, timeout
        self.names = [c["name"] for c in cases]
        out.mkdir(parents=True, exist_ok=True)
        job = out / "job.json"
        job.write_text(json.dumps(cases))
        env = dict(os.environ, PYTHONPATH=SRC, **env)
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        self.procs = [
            subprocess.Popen(
                [sys.executable, __file__, str(r), str(n),
                 "file://" + str(out / "rdv"), str(job), str(out), device,
                 backend],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
            for r in range(n)
        ]
        self._ends = self._results = None

    def wait(self) -> list:
        """[(exit code, or None past the timeout; stderr)] a rank; every
        rank is killed once one outlives the timeout."""
        if self._ends is None:
            self._ends = []
            for p in self.procs:
                try:
                    _, err = p.communicate(timeout=self.timeout)
                    self._ends.append((p.returncode, err))
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    _, err = p.communicate()
                    self._ends.append((None, err))
        return self._ends

    def results(self) -> dict:
        """{case name: [rank 0's dict, rank 1's, ...]}; raises with the
        ranks' stderr if any rank failed or outlived the timeout."""
        if self._results is None:
            errs = [f"rank {r} exited {rc}\n{err}"
                    for r, (rc, err) in enumerate(self.wait()) if rc != 0]
            if errs:
                raise RuntimeError("\n".join(errs))
            self._results = {
                name: [dict(np.load(self.out / f"{name}.r{r}.npz"))
                       for r in range(self.n)]
                for name in self.names
            }
        return self._results


def launch(out: Path, n: int, cases: list, timeout: float = 240,
           device: str = "cpu", backend: str = "gloo",
           env: dict | None = None) -> Batch:
    return Batch(Path(out), n, cases, timeout, device, backend, env or {})


def rand_reads(seed, n=5, lo=40, hi=300):
    """tests/test_dist.py's random reads."""
    rng = np.random.default_rng(seed)
    return [
        "".join(rng.choice(list("ACGT"), size=int(rng.integers(lo, hi))))
        for _ in range(n)
    ]


def poly_t_reads(L):
    """A read with L consecutive 'T's: at m = 32 and L >= 32 the JAX
    tier's pad sentinel is also a real edge key."""
    rng = np.random.default_rng(1)

    def r(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    return [r(80) + "T" * L + r(50), r(120), r(70), r(90)]


def every_rank(results: list, want):
    """Every rank returned the whole result, equal to want's bwt6,
    sharp_pos and dollar_pos."""
    for res in results:
        assert "error" not in res, res.get("error")
        np.testing.assert_array_equal(res["bwt6"], want.bwt6)
        np.testing.assert_array_equal(res["sharp"], want.sharp_pos)
        assert int(res["dollar"]) == want.dollar_pos


# ---------------------------------------------------------------------------
# cases (the rank processes)
# ---------------------------------------------------------------------------


def _coll(case):
    """The case's reads, or the synthetic collection of case["mbp"]."""
    if "mbp" in case:
        from debwt_tpu_torch.synth import synth_collection

        return synth_collection(case["mbp"])
    from debwt_tpu_torch.types import SequenceCollection

    return SequenceCollection.from_reads(case["reads"])


def _config(case):
    from debwt_tpu_torch.types import PipelineConfig

    return PipelineConfig(m=case.get("m", 32))


def _result(res) -> dict:
    return dict(bwt6=res.bwt6, sharp=res.sharp_pos,
                dollar=np.int64(res.dollar_pos),
                packed=np.frombuffer(res.packed(), dtype=np.uint8),
                timings=np.str_(json.dumps(res.timings)))


def case_build(mesh, case):
    from debwt_tpu_torch.parallel import dist

    dbg = {} if case.get("debug") else None
    dist.DEBUG = dbg
    try:
        res = dist.dist_build_bwt(_coll(case), _config(case), mesh)
    finally:
        dist.DEBUG = None
    out = _result(res)
    for key, v in (dbg or {}).items():
        out["dbg_" + key] = np.asarray(v)
    return out


def case_sprank(mesh, case):
    """This rank's block of sp_ranks_sharded over blocks of
    max(8, ceil(L/n)) (the JAX test's layout)."""
    import torch

    from debwt_tpu_torch.parallel.sprank import sp_ranks_sharded

    sp6 = np.asarray(case["sp6"], dtype=np.uint8)
    L = sp6.shape[0]
    Pb = max(8, -(-L // mesh.n))
    full = np.zeros(mesh.n * Pb, dtype=np.uint8)
    full[:L] = sp6
    blk = torch.from_numpy(full[mesh.rank * Pb : (mesh.rank + 1) * Pb].copy())
    return {"rank": sp_ranks_sharded(mesh, blk, L).numpy()}


def case_ooc(mesh, case):
    """build_bwt_ooc with the mesh; the case may set OocConfig's chunk,
    n_buckets, sp_cap, spill_dir and checkpoint."""
    from debwt_tpu_torch.oocore import OocConfig, build_bwt_ooc

    knobs = ("chunk", "n_buckets", "sp_cap", "spill_dir", "checkpoint")
    stats = {}
    res = build_bwt_ooc(
        _coll(case), _config(case),
        OocConfig(**{k: case[k] for k in knobs if k in case}),
        stats=stats, device=mesh.device, mesh=mesh,
    )
    return dict(_result(res), sharded_rank=np.bool_(stats["sharded_rank"]),
                sp_len=np.int64(stats["sp_len"]))


def case_api(mesh, case):
    """api.build with n_devices (the forced route), or with a lowered
    single-device bound (the route of a joined group over the bound);
    counts the calls that reached dist_build_bwt."""
    from debwt_tpu_torch import api
    from debwt_tpu_torch.parallel import dist

    real, calls = dist.dist_build_bwt, []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    bound = api._SINGLE_ROWS
    dist.dist_build_bwt = counted
    if case.get("single_rows"):
        api._SINGLE_ROWS = case["single_rows"]
    try:
        res = api.build(_coll(case), _config(case), device=mesh.device,
                        n_devices=case.get("n_devices"))
    finally:
        dist.dist_build_bwt, api._SINGLE_ROWS = real, bound
    return dict(_result(res), dist_calls=np.int64(len(calls)))


def case_guard(mesh, case):
    """A collection too long for int32 shard arrays on this mesh."""
    from debwt_tpu_torch.parallel.dist import dist_build_bwt
    from debwt_tpu_torch.types import PipelineConfig

    class Huge:
        bwt_len = case["bwt_len"]
        n_reads = 4

    dist_build_bwt(Huge(), PipelineConfig(), mesh)
    return {}


def case_rank_card(mesh, case):
    """api.build with no device named, on a host faked to have
    case["cards"] cards and LOCAL_RANK = rank + case["local_offset"]:
    the devices single_rows_bound, the fused build and set_device got.
    The build itself runs on this rank's own device."""
    import torch

    from debwt_tpu_torch import api

    os.environ["LOCAL_RANK"] = str(mesh.rank + case["local_offset"])
    seen = {"bound": [], "build": [], "set_device": []}
    real_build = api.build_bwt
    fakes = [
        (torch.cuda, "is_available", lambda: True),
        (torch.cuda, "device_count", lambda: case["cards"]),
        (torch.cuda, "set_device", seen["set_device"].append),
        (api, "single_rows_bound",
         lambda dev: seen["bound"].append(dev) or api.MAX_ROWS),
        (api, "build_bwt", lambda coll, config, device: seen["build"].append(
            device) or real_build(coll, config, device=mesh.device)),
    ]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in fakes]
    for obj, name, fake in fakes:
        setattr(obj, name, fake)
    try:
        res = api.build(_coll(case), _config(case))
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
        del os.environ["LOCAL_RANK"]
    return dict(_result(res),
                **{k: np.array([str(d) for d in v]) for k, v in seen.items()})


def case_cli(mesh, case):
    """The CLI's main() in the joined group on a FASTA of the case's
    reads, with case["args"]; with case["tamper"], api.build's result
    has one character flipped on every rank. Returns the exit code and
    what the CLI wrote to stderr."""
    import contextlib
    import io
    import tempfile

    import torch

    from debwt_tpu_torch import api
    from debwt_tpu_torch.cli import main as cli_main
    from debwt_tpu_torch.pipeline import BwtResult

    real = api.build

    def tampered(*a, **kw):
        r = real(*a, **kw)
        bad = r.bwt6.copy()
        bad[int(np.nonzero(bad < 4)[0][9])] ^= 1
        return BwtResult.from_bwt6(torch.from_numpy(bad), r.sharp_pos.shape[0] + 1)

    err = io.StringIO()
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "in.fa")
        with open(fa, "w") as f:
            f.write("".join(f">r{i}\n{r}\n" for i, r in enumerate(case["reads"])))
        if case.get("tamper"):
            api.build = tampered
        try:
            with contextlib.redirect_stderr(err):
                rc = cli_main(["-o", os.path.join(d, "out.bwt"), "--device",
                               str(mesh.device.type), *case["args"], fa])
        finally:
            api.build = real
    return {"rc": np.int64(rc), "stderr": np.str_(err.getvalue())}


def case_probe(mesh, case):
    """One all_reduce of ones on the rank's device."""
    import torch

    t = torch.ones(4, device=mesh.device)
    torch.distributed.all_reduce(t)
    return {"sum": t.cpu().numpy()}


CASES = {"build": case_build, "sprank": case_sprank, "ooc": case_ooc,
         "api": case_api, "guard": case_guard, "probe": case_probe,
         "rank_card": case_rank_card, "cli": case_cli}


def main(argv) -> int:
    rank, n, init, job, out = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    device = argv[5] if len(argv) > 5 else "cpu"
    backend = argv[6] if len(argv) > 6 else "gloo"
    import torch

    from debwt_tpu_torch.kernels import seg_or, window_keys
    from debwt_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from torch_ooc_worker import io_bytes

    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(init, n, rank, backend=backend)
    mesh = make_mesh(n, device=device)
    counters = {"window_keys": window_keys.window_keys,
                "window_keys_at": window_keys.window_keys_at,
                "seg_scan_or": seg_or.seg_scan_or}
    with open(job) as f:
        cases = json.load(f)
    for case in cases:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            res = CASES[case["kind"]](mesh, case)
        except Exception as e:  # noqa: BLE001 — the test reads the error
            if not case.get("expect_error"):
                raise
            res = {"error": np.str_(f"{type(e).__name__}: {e}")}
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        res["seconds"] = np.float64(time.perf_counter() - t0)
        for name, fn in counters.items():
            res["launches_" + name] = np.int64(fn.launches)
        res["io_wchar"] = np.int64(io_bytes().get("wchar", 0))
        np.savez(os.path.join(out, f"{case['name']}.r{rank}.npz"), **res)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
