"""The multi-card gang on the CPU: ``graft.dryrun_multichip`` at a world
of 2 and 4 over gloo, ``python -m dmlc_tpu_torch.graft`` (the twin of
``python __graft_entry__.py``) and ``init_from_env``'s card a rank.

Every gang runs in subprocesses started by ``launch_local`` (through
the twin's ``--cards``), never in the pytest process. Each rank checks
its own ``w`` and ``b`` against the golden over the gathered global
batches at the dry run's unchanged ``RTOL``/``ATOL``; here the ranks'
final ``w`` must be bitwise equal, and equal at the same bar to the
world-1 run's and to the reference's sharded step over its 8-device CPU
mesh: all of them are the same SGD steps on the same global batches.
At a world above 1 the iterator caches epoch 1, so the dry run's
steady-replay check sees epochs 2 and 3 served from memory (2 replayed
epochs), not 1. chip_smoke's multi-card phase, which runs its legs only
on a host of several cards, is rehearsed here over 2 gloo ranks at its
cut widths.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from dmlc_tpu_torch import graft
from dmlc_tpu_torch.parallel import launch
from dmlc_tpu_torch.parallel.launch import NotEnoughCardsError
from dmlc_tpu_torch.utils.logging import DMLCError
from test_torch_sharded_models import _ref_dryrun_w

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = 8
ENV = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
# a number, or a 12-digit hex digest
NUMBER = re.compile(r"\b[0-9a-f]{12}\b|-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
DRYRUN = re.compile(r"^dryrun_multichip\(\d+\): .*\(mesh=\S+ golden=\S+\)")


def _run(args, timeout=300):
    return subprocess.run([sys.executable] + args, cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def ref_mesh():
    return RefMesh(np.array(jax.devices()[:PARTS]).reshape(PARTS),
                   ("data",))


@pytest.fixture(scope="module")
def world_one():
    return graft.dryrun_multichip(PARTS, device="cpu")


@pytest.fixture(scope="module")
def reference_w(ref_mesh, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "d.libsvm")
    graft.write_dryrun_corpus(path, PARTS)
    return _ref_dryrun_w(path, ref_mesh)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def gang(request, tmp_path_factory):
    """The twin's gang of ``world`` gloo ranks over one 8-part mesh:
    (world, the run, each rank's final w in rank order)."""
    world = request.param
    out = tmp_path_factory.mktemp(f"gang{world}")
    r = _run(["-m", "dmlc_tpu_torch.graft", "--device", "cpu", "--cards",
              str(world), "--parts", str(PARTS), "--out", str(out)])
    ws = [np.load(out / f"w-{rank}-of-{world}.npy")
          for rank in range(world) if r.returncode == 0]
    return world, r, ws


def test_every_rank_passes_its_parity(gang):
    world, r, ws = gang
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    runs = [ln for ln in lines if ln.startswith(f"dryrun_multichip({PARTS})")]
    assert len(runs) == world and len(ws) == world, r.stdout
    assert sorted(int(re.search(r"rank=(\d+)", ln).group(1))
                  for ln in runs) == list(range(world))
    for ln in runs:
        assert f"world={world} " in ln and DRYRUN.match(ln)
        # epoch 1 cached at a world above 1: epochs 2 and 3 replayed
        assert "steady replay OK (2 epoch(s)" in ln
        assert "model-axis phase OK (2-D 4x2" in ln
    assert sum(ln.startswith("entry() compile+run: ")
               for ln in lines) == world


def test_the_ranks_end_bitwise_equal(gang):
    world, r, ws = gang
    assert r.returncode == 0, r.stderr[-3000:]
    assert all(w.tobytes() == ws[0].tobytes() for w in ws)


def test_the_gang_w_is_the_world_one_and_the_reference_w(
        gang, world_one, reference_w):
    world, r, ws = gang
    assert r.returncode == 0, r.stderr[-3000:]
    w_ref, _, nbatches = reference_w
    assert world_one["batches"] == nbatches and world_one["world"] == 1
    np.testing.assert_allclose(ws[0], world_one["w"], rtol=graft.RTOL,
                               atol=graft.ATOL)
    np.testing.assert_allclose(ws[0], w_ref, rtol=graft.RTOL,
                               atol=graft.ATOL)


def _shape(line):
    """A printed line with its numbers and digests masked, cut before the
    2-D phase's note (the reference's "TP seam", the port's "model-axis
    phase") and with the parity verdict masked (bitwise or not depends
    on the order of the sums)."""
    line = re.split(r"; (?:TP seam|model-axis phase) OK", line)[0]
    return NUMBER.sub("#", line.replace("BITWISE", "allclose"))


def test_the_twin_prints_the_reference_line_shapes():
    port = _run(["-m", "dmlc_tpu_torch.graft", "--device", "cpu"])
    ref = _run(["__graft_entry__.py"])
    assert port.returncode == 0, port.stderr[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    got, want = port.stdout.splitlines(), ref.stdout.splitlines()[-2:]
    assert len(got) == 2
    assert [_shape(ln) for ln in got] == [_shape(ln) for ln in want]
    assert got[1].endswith("; world=1 rank=0 on cpu")
    assert "model-axis phase OK (2-D 4x2 data*model mesh" in got[1]


def test_the_multicard_legs_rehearse_on_the_host(tmp_path, monkeypatch):
    """chip_smoke's ``multicard_path`` at W = 2 over gloo, at its
    ``MULTICARD_REHEARSAL`` widths: legs (a) to (e) with every check of
    the cards' run but the launch counts and the NCCL legs (the phase
    exits on a failed check). It drives the worker script that runs
    only on a host of several cards."""
    import chip_smoke as cs
    for name, value in cs.MULTICARD_REHEARSAL.items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setenv("DMLC_TPU_TORCH_PAGESTORE_DIR", str(tmp_path / "p"))
    # two threads a process: a torch process takes every core by default,
    # and each leg runs two or more of them at once
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    linear = str(tmp_path / "criteo_shaped.libsvm")
    size = cs.write_corpus(linear)
    out = cs.multicard_path(linear, cs.LEARNING_RATE, str(tmp_path),
                            device="cpu", cards=2)
    assert out["cards"] == out["host_cards"] == 2
    train, placed = out["train"], out["placed"]
    assert train["parts"] == 4 and train["steps"] >= 3
    assert train["losses"][1] < train["losses"][0]
    assert len(train["parity_max_err"]) == 2
    # W = 2: each rank's parts 2r, 2r + 1 hold both model slices
    n_feat = cs.NUM_FEATURES
    data = n_feat * cs.FFM_FIELDS * cs.FFM_FACTORS * 4 + n_feat * 4 + 4
    assert all(data <= b <= data + 4 * cs.PLACEMENT_FRAMING
               for b in placed["restore_bytes_read"])
    assert placed["stored_bytes"] > data
    assert out["config7"]["gloo"]["bytes"] > 0
    assert out["distributed_launch"]["cpu_s"] > 0
    assert os.path.getsize(linear) == size


@pytest.mark.parametrize("cards", [None, 1, 2, 4])
def test_the_twin_on_a_host_without_a_card_refuses(cards, monkeypatch):
    """No card here: the twin raises before any rank starts."""
    assert not torch.cuda.is_available()
    started = []
    monkeypatch.setattr(launch, "launch_local",
                        lambda *a, **k: started.append(a))
    argv = [] if cards is None else ["--cards", str(cards)]
    with pytest.raises(NotEnoughCardsError, match="has 0"):
        graft.main(argv)
    assert not started


# ----------------------------------------------------- a card a rank

def _init(monkeypatch, coord, world, task, cards, device=None):
    """``init_from_env`` under a monkeypatched host of ``cards`` cards,
    with no group formed: returns the device it handed NCCL."""
    monkeypatch.delenv("DMLC_ROLE", raising=False)
    monkeypatch.setenv(launch.ENV_COORD, coord)
    monkeypatch.setenv(launch.ENV_NWORKER, str(world))
    monkeypatch.setenv(launch.ENV_TASK_ID, str(task))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    got = {}

    def fake_init(backend, **kw):
        got.update(kw, backend=backend)

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    assert launch.init_from_env(device=device) == (task, world)
    assert got["backend"] == "nccl" and got["rank"] == task
    assert got["world_size"] == world
    return got["device_id"]


@pytest.mark.parametrize("coord,world,task,cards,device,want", [
    ("127.0.0.1:29500", 4, 0, 4, None, 0),
    ("127.0.0.1:29500", 4, 3, 4, None, 3),
    ("127.0.0.1:29500", 2, 1, 8, None, 1),
    ("localhost:29500", 2, 1, 2, "cuda", 1),
    # ranks across hosts: the global task id modulo this host's cards
    ("10.0.0.1:29500", 8, 5, 4, None, 1),
    # an explicit card is kept, whatever the count
    ("127.0.0.1:29500", 4, 3, 2, "cuda:1", 1),
])
def test_init_from_env_gives_each_rank_its_card(monkeypatch, coord, world,
                                                task, cards, device, want):
    dev = _init(monkeypatch, coord, world, task, cards, device)
    assert dev == torch.device("cuda", want)


@pytest.mark.parametrize("coord", ["127.0.0.1:29500", "localhost:1",
                                   "[::1]:29500"])
@pytest.mark.parametrize("task", [0, 3])
def test_init_from_env_refuses_ranks_that_share_a_card(monkeypatch, coord,
                                                       task):
    with pytest.raises(NotEnoughCardsError) as e:
        _init(monkeypatch, coord, 4, task, 2)
    msg = str(e.value)
    assert (f"rank {task} of 4" in msg and f"card {task % 2}" in msg
            and "2 card(s)" in msg)
    assert isinstance(e.value, DMLCError)


def test_init_from_env_force_without_a_coordinator_raises(monkeypatch):
    for name in (launch.ENV_COORD, "DMLC_TRACKER_URI", "DMLC_ROLE"):
        monkeypatch.delenv(name, raising=False)
    assert launch.init_from_env(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(DMLCError, match=launch.ENV_COORD):
        launch.init_from_env(device="cpu", force=True)
