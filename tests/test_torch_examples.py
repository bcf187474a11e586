"""The port's example twins against the reference's examples.

Each twin under ``examples/torch_port/`` runs as a real subprocess on the
CPU (``--device cpu`` where it touches a device) beside its reference
under ``examples/`` (``TABLE`` pairs them), and their standard output
must be the same line for line under the rules of ``same_output``. Both
are ``chip_smoke.py``'s, which holds each twin's run on the card to its
CPU run with the same rules. The
reference runs as ``JAX_PLATFORMS=cpu python <example>`` would, without
the test process's ``XLA_FLAGS``, so its device count is the one its own
code picks: 8 virtual devices where the example asks for them, else 1.

The pairs are split over files (``SHARE``: this one and
``test_torch_examples_{train,fm,launch}.py``), each of which
``--dist loadfile`` keeps on one worker, so no file holds more than about
40 s of subprocesses on one core. Each file also checks that its twins
refuse to run without a card when not given ``--device cpu``.
"""

import os
import subprocess
import sys

import pytest

from chip_smoke import TABLE, same_output

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
TWINS = os.path.join(EXAMPLES, "torch_port")

# twin -> the test file that runs its pair
SHARE = {
    "data_pipeline.py": "test_torch_examples.py",
    "pipeline_quickstart.py": "test_torch_examples.py",
    "cuda_device_ingest.py": "test_torch_examples.py",
    "train_sparse_linear.py": "test_torch_examples_train.py",
    "train_ranking.py": "test_torch_examples_train.py",
    "train_fm.py": "test_torch_examples_fm.py",
    "distributed_launch.py": "test_torch_examples_launch.py",
}

def _run(path, args=(), jax_env=False):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
    if jax_env:
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, path, *args], env=env,
                       cwd=os.path.dirname(path), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def check_pair(name):
    """Run ``name``'s reference and the twin (on the CPU) and hold the
    twin's lines to the reference's."""
    ref, takes_device = TABLE[name]
    want = _run(os.path.join(EXAMPLES, ref), jax_env=True)
    got = _run(os.path.join(TWINS, name),
               ["--device", "cpu"] if takes_device else [])
    ok, diff = same_output(want, got, "cpu", "cpu")
    assert ok, f"{name} against {ref}: {diff}\n--- reference\n{want}" \
               f"\n--- twin\n{got}"


def check_needs_card(name):
    """No card here: the twin run without ``--device cpu`` fails (it
    targets the card and does not fall back to the host)."""
    import torch
    assert not torch.cuda.is_available()
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, os.path.join(TWINS, name)],
                       env=env, cwd=TWINS, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "OK" not in r.stdout and "parent restored" not in r.stdout


def share(filename, device=False):
    """The twins whose pair ``filename`` runs (with ``device``, those of
    them that take ``--device``)."""
    return sorted(t for t, f in SHARE.items()
                  if f == filename and (TABLE[t][1] or not device))


@pytest.mark.parametrize("name", share("test_torch_examples.py"))
def test_twin_prints_what_the_reference_prints(name):
    check_pair(name)


@pytest.mark.parametrize("name", share("test_torch_examples.py", True))
def test_a_twin_needs_a_card_without_device_cpu(name):
    check_needs_card(name)


def test_every_twin_has_its_reference_and_a_share():
    twins = {f for f in os.listdir(TWINS) if f.endswith(".py")}
    assert twins == set(TABLE) == set(SHARE)
    here = os.path.dirname(os.path.abspath(__file__))
    for name, (ref, _) in TABLE.items():
        assert os.path.exists(os.path.join(EXAMPLES, ref))
        assert os.path.exists(os.path.join(here, SHARE[name]))


# The rules themselves, on lines the examples print.
RULE_CASES = [
    # (reference line, twin line, twin device, same?)
    ("epoch 0: mean loss 0.5107 (10 steps, 1.30s, parsed)",
     "epoch 0: mean loss 0.5107 (10 steps, 2.83s, parsed)", "cpu", True),
    ("epoch 0: mean loss 0.5107 (10 steps, 1.30s, parsed)",
     "epoch 0: mean loss 0.5108 (10 steps, 1.30s, parsed)", "cpu", True),
    ("epoch 0: mean loss 0.5107 (10 steps, 1.30s, parsed)",
     "epoch 0: mean loss 0.5109 (10 steps, 1.30s, parsed)", "cpu", False),
    ("epoch 0: mean loss 0.5107 (10 steps, 1.30s, parsed)",
     "epoch 0: mean loss 0.5107 (11 steps, 1.30s, parsed)", "cpu", False),
    ("epoch 0: mean loss 0.5107 (10 steps, 1.30s, parsed)",
     "epoch 0: mean loss 0.5107 (10 steps, 1.30s, replayed)", "cpu", False),
    ("  stage prefetch: items=5 rows=20000 wait=0.009s occupancy=0.35",
     "  stage prefetch: items=5 rows=20000 wait=0.007s occupancy=0.05",
     "cpu", True),
    ("  stage prefetch: items=5 rows=20000 wait=0.009s occupancy=0.35",
     "  stage prefetch: items=4 rows=20000 wait=0.007s occupancy=0.05",
     "cpu", False),
    ("autotuned knobs: {'prefetch.depth': 4, 'device.window': 4} "
     "(changed: none yet)",
     "autotuned knobs: {'prefetch.depth': 2, 'device.window': 4} "
     "(changed: {'prefetch.depth': 2})", "cuda", True),
    ("autotuned knobs: {'prefetch.depth': 4, 'device.window': 4} "
     "(changed: none yet)",
     "autotuned knobs: {'prefetch.depth': 4} (changed: none yet)", "cpu",
     False),
    ("autotuned knobs: {'prefetch.depth': 4, 'device.window': 4} "
     "(changed: none yet)",
     "autotuned knobs: {'prefetch.depth': 4, 'copy.window': 4} "
     "(changed: none yet)", "cpu", False),
    ("mesh: 8 devices on cpu", "mesh: 8 devices on cuda", "cuda", True),
    ("mesh: 8 devices on cpu", "mesh: 8 devices on cpu", "cuda", False),
    ("mesh: 8 devices on cpu", "mesh: 4 devices on cuda", "cuda", False),
    ("device_chunks: 2 chunks, 460356 bytes on cpu",
     "device_chunks: 2 chunks, 460356 bytes on cuda", "cuda", True),
    ("parent restored params w[:4]=[0.0006428092019632459, -0.5] "
     "trained loss=0.6933",
     "parent restored params w[:4]=[0.0006428089691326022, -0.5] "
     "trained loss=0.6933", "cpu", True),
    ("parent restored params w[:4]=[0.0006428092019632459, -0.5] "
     "trained loss=0.6933",
     "parent restored params w[:4]=[0.0006438092019632459, -0.5] "
     "trained loss=0.6933", "cpu", False),
    ("sharded: 20000 rows across 1 devices",
     "sharded: 20000 rows across 1 devices", "cpu", True),
]


@pytest.mark.parametrize("want,got,device,same", RULE_CASES)
def test_the_per_line_rules(want, got, device, same):
    assert same_output(want, got, "cpu", device)[0] is same


INGEST = ("recordio_device_batches: 500 records across {} device shards, "
          "on-device checksum OK (63839447)")
# (the card run's shards, the host's cards, same?): the host run has 1
CARD_CASES = [(1, 1, True), (2, 2, True), (4, 4, True), (4, 8, True),
              (1, 2, False), (2, 1, False), (8, 8, False), (3, 4, False)]


@pytest.mark.parametrize("shards,cards,same", CARD_CASES)
def test_a_card_run_counts_its_cards(shards, cards, same):
    host, card = INGEST.format(1), INGEST.format(shards)
    assert same_output(host, card, "cpu", "cuda", reference=False,
                       cards=cards)[0] is same
    # a twin against its reference counts as the reference does
    assert same_output(host, card, "cpu", "cuda")[0] is (shards == 1)


def test_gang_lines_and_the_collective_log():
    # as the reference's two workers wrote them once: the log's lines
    # broken into each other, blank lines, two records on one line
    want = ("[Gloo] Rank [Gloo] Rank 01 is connected to  is connected to "
            "11 peer ranks.  peer ranks. Expected number of connected "
            "peer ranks is : Expected number of connected peer ranks is "
            ": 11\n\n3\n"
            "1 peer ranks. Expected number of connected peer ranks is : 1\n"
            "[worker 1/2] devices=4 final loss=0.6933[worker 0/2] "
            "devices=4 final loss=0.6933\n\n"
            "parent restored params w[:4]=[0.1] trained loss=0.6933\n")
    got = ("[worker 0/2] devices=4 final loss=0.6933\n"
           "[worker 1/2] devices=4 final loss=0.6933\n"
           "parent restored params w[:4]=[0.1] trained loss=0.6933\n")
    assert same_output(want, got, "cpu", "cpu")[0]
    assert not same_output(want, got.replace("0/2", "0/3"), "cpu", "cpu")[0]
    # the twin's output gets none of the reference's allowances
    assert not same_output(want, "[Gloo] x\n" + got, "cpu", "cpu")[0]
    assert not same_output(want, got + "\n", "cpu", "cpu")[0]
    assert not same_output(want, got.replace("6933\n[worker 1", "6933[worker 1"),
                           "cpu", "cpu")[0]
    assert not same_output(want, "", "cpu", "cpu")[0]
    assert not same_output("", "", "cpu", "cpu")[0]  # no output is a fault
    # a twin against its own CPU run (chip_smoke): no allowance either way
    assert same_output(got, got.replace("loss=0.6933", "loss=0.6934"),
                       "cpu", "cuda", reference=False)[0]
    assert not same_output("\n" + got, got, "cpu", "cuda",
                           reference=False)[0]
