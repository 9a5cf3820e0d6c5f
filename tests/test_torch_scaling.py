"""The port's bench harness and scaling measurement on two gloo ranks on the
CPU (``tpupt_torch/bench/harness.py``, ``tpupt_torch/bench/scaling.py``).

* ``run_config("multimesh", size=16)`` on two ranks, the windows patched
  short (one window, at most two calls): ``extra`` carries
  ``sharded_mrays``, ``devices`` and ``scaling_eff`` on both ranks.  Rank
  1's clock runs a million times slower, so on its own it would make two
  calls a window where rank 0 makes one; the joint stop decision makes
  both make two, and the run finishes (without it the ranks' collectives
  stop pairing up and the group times out).  Every sharded call's gathered
  image is EQUAL to this process's render of the same work, and so are
  its rays.
* ``scaling.measure`` at 32^2, 1 spp, 2 bounces: it finishes, and its
  dict has the JAX package's keys (read from ``tpupt/bench/scaling.py``'s
  source) plus "device"; it raises unless the single-process and sharded
  rays are equal.

This module imports no JAX: the spawned ranks import it.
"""

import ast
import datetime
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tpupt_torch.bench import harness, scaling
from tpupt_torch.dist import sharding
from tpupt_torch.render.integrator import render_image

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 16
SLOW_CLOCK = 1e-6  # rank 1's clock rate


def _rank_main(rank, store, path):
    """One rank of ``run_config("multimesh", size=SIZE)``: the result and
    every sharded call's gathered buffers and rays (or the traceback),
    pickled to ``path``."""
    torch.set_num_threads(1)
    res = {}
    try:
        harness._MIN_WINDOW_S, harness._N_WINDOWS, harness._MAX_ITERS = 1e-3, 1, 2
        if rank == 1:
            real = time.perf_counter
            time.perf_counter = lambda: real() * SLOW_CLOCK
        calls = res["sharded_calls"] = []
        render_sharded = sharding.render_image_sharded

        def recording(*args, **kw):
            buf, rays = render_sharded(*args, **kw)
            calls.append((buf.color.numpy().copy(), buf.depth.numpy().copy(), int(rays)))
            return buf, rays

        sharding.render_image_sharded = recording
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        res["result"] = harness.run_config("multimesh", iters=1, size=SIZE, device="cpu")
    except Exception:  # the parent reports it
        res = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(path, "wb") as fh:
        pickle.dump(res, fh)


def test_run_config_multimesh_on_two_ranks(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    paths = [tmp_path / f"rank{r}.pkl" for r in range(2)]
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp_path / "store"), str(paths[r])))
             for r in range(2)]
    for p in procs:
        p.start()
    # meanwhile, this process's render of the work each sharded call does
    # (the JAX harness's bench_sharded passes no roulette)
    cfg = harness.CONFIGS["multimesh"]
    scene, camera = cfg["scene"](device="cpu")
    want, want_rays = render_image(scene, camera, SIZE, SIZE, cfg["spp"], max_bounces=cfg["mb"])
    for p in procs:
        p.join(timeout=400)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = []
    for path in paths:
        with open(path, "rb") as fh:
            res = pickle.load(fh)  # written by the ranks above
        assert "error" not in res, res["error"]
        ranks.append(res)
    for res in ranks:
        extra = res["result"].extra
        assert set(extra) == {"sharded_mrays", "devices", "scaling_eff"}, extra
        assert extra["devices"] == 2 and extra["sharded_mrays"] > 0 and extra["scaling_eff"] > 0
        # the warm-up and the two calls of the window rank 1's clock asks for
        assert len(res["sharded_calls"]) == 3
        for color, depth, rays in res["sharded_calls"]:
            assert rays == int(want_rays)
            np.testing.assert_array_equal(color, want.color.numpy())
            np.testing.assert_array_equal(depth, want.depth.numpy())
    # both ranks timed the sharded windows by the slower of their clocks
    assert ranks[0]["result"].extra["sharded_mrays"] == ranks[1]["result"].extra["sharded_mrays"]


def _jax_scaling_keys():
    """The keys of the dict ``tpupt/bench/scaling.py`` prints."""
    with open(os.path.join(ROOT, "tpupt", "bench", "scaling.py")) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps of a dict literal")


def test_scaling_measure_on_two_ranks():
    out = scaling.measure(2, size=32, spp=1, mb=2, device="cpu", min_seconds=0.2, timeout=400)
    keys = _jax_scaling_keys()
    assert len(keys) == 16
    assert list(out) == keys + ["device"]
    assert out["devices"] == 2 and out["device"] == "cpu"
    assert out["work"] == "32x32 spp=1 mb=2 per call"
    for k in keys:
        if k.startswith(("single", "sharded", "fwd_bwd", "efficiency")):
            assert out[k] > 0, k
