"""The port's multi-process runtime (relationprediction_torch/parallel/
distributed.py) and train.py's mesh and multi-host flags on gloo CPU
ranks (tests/test_multihost.py of the JAX package): the launcher, a
failed rank, the mesh rules, two launched processes of 2 ranks against
one process of 4, a restart that resumes bit for bit, and the CLI.
Every rank runs torch on one thread."""
import os
import pathlib
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from relationprediction_torch import train as torch_train
from relationprediction_torch.graph import build_graph_batch
from relationprediction_torch.models import encoders
from relationprediction_torch.observability import MetricLogger
from relationprediction_torch.parallel import distributed
from relationprediction_torch.parallel.mesh import (check_devices, make_mesh,
                                                    replicate, shard_batch,
                                                    shard_rows)
from relationprediction_torch.params import tree_leaves
from relationprediction_torch.training import checkpoint
from relationprediction_torch.training.engine import TrainBatch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOY = str(ROOT / "data" / "Toy")


# ---------------------------------------------------------------------------
# The launcher and the mesh
# ---------------------------------------------------------------------------

def _fail_on_rank_1(mesh):
    torch.set_num_threads(1)
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    # Rank 0 waits in a collective that rank 1 never joins.
    dist.all_reduce(torch.ones(1), group=mesh.group)
    return "rank 0 finished"


def test_a_failed_rank_fails_the_launch():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*on purpose"):
        distributed.launch(_fail_on_rank_1, 2, cpu=True, timeout=120)
    assert time.perf_counter() - t0 < 60


def _mesh_rules(mesh, out_dir):
    torch.set_num_threads(1)
    logger = MetricLogger(os.path.join(out_dir, f"m-{mesh.rank}.jsonl"))
    logger.log("rank", rank=mesh.rank)
    logger.close()
    total = torch.tensor([float(mesh.rank + 1)])
    dist.all_reduce(total, group=mesh.group)
    out = {"rank": mesh.rank, "world": mesh.world_size,
           "backend": mesh.backend, "device": str(mesh.device),
           "local_rank": int(os.environ["LOCAL_RANK"]),
           "coordinator": distributed.is_coordinator(),
           "sum": total.item()}
    # The default mesh is the cards, over gloo too: where there is none it
    # raises rather than fall back to the CPU.
    try:
        out["default"] = str(make_mesh().device)
    except Exception as e:  # no card: read below
        out["default"] = type(e).__name__
    for n in (3, 2, 8):
        try:
            distributed.make_global_mesh(n, ["cpu"] * mesh.world_size)
        except ValueError as e:
            out[n] = str(e)
    out["global"] = distributed.make_global_mesh(
        mesh.world_size, ["cpu"] * mesh.world_size).world_size
    # Rank 0's tree on every rank, a copy; this rank's rows.
    mine = {"w": torch.full((2,), float(mesh.rank))}
    tree = replicate(mesh, mine)
    out["replicated"] = tree["w"].tolist()
    out["aliased"] = tree["w"].data_ptr() == mine["w"].data_ptr()
    batch = TrainBatch(None, torch.arange(24).view(8, 3), torch.ones(8))
    out["rows"] = shard_batch(mesh, batch).triples[:, 0].tolist()
    return out


def test_two_launched_processes_of_two_ranks(tmp_path):
    """Two launches (processes 0 and 1) of two ranks each make one group
    of 4, rank process_id * 2 + local; only rank 0 is the coordinator and
    writes metric records. NCCL on a card two ranks share raises, naming
    gloo; make_global_mesh keeps the JAX package's two rules (a multiple
    of the ranks a process; every process) and takes the world size."""
    port = distributed.free_port()
    results, errors = {}, []

    def process(pid):
        try:
            results[pid] = distributed.launch(
                _mesh_rules, 2, (str(tmp_path),), cpu=True,
                coordinator=f"localhost:{port}", num_processes=2,
                process_id=pid, timeout=120)
        except Exception as e:  # read below
            errors.append(e)
    threads = [threading.Thread(target=process, args=(p,)) for p in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not errors and not any(t.is_alive() for t in threads)
    ranks = results[0] + results[1]
    assert [(r["rank"], r["local_rank"]) for r in ranks] \
        == [(0, 0), (1, 1), (2, 0), (3, 1)]
    assert [r["coordinator"] for r in ranks] == [True, False, False, False]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m-0.jsonl"]
    for r in ranks:
        assert r["world"] == 4 and r["backend"] == "gloo" \
            and r["device"] == "cpu" and r["sum"] == 10.0
        if torch.cuda.device_count() >= 2:
            assert r["default"] == f"cuda:{r['local_rank']}"
        assert r["default"] != "cpu"
        assert "multiple" in r[3] and "every process" in r[2] \
            and "world of 4" in r[8]
        assert r["global"] == 4
        assert r["replicated"] == [0.0, 0.0] and not r["aliased"]
        assert r["rows"] == [6 * r["rank"], 6 * r["rank"] + 3]


def _mesh_device(mesh):
    return mesh.backend, str(mesh.device)


def test_launch_runs_on_the_cards_unless_asked_for_the_cpu():
    """By default a launch is NCCL on cuda:<local rank>; where that cannot
    run it fails, and never falls back to gloo or the CPU."""
    assert distributed.launch(_mesh_device, 1, cpu=True, timeout=120) \
        == [("gloo", "cpu")]
    if torch.cuda.is_available():
        assert distributed.launch(_mesh_device, 1, timeout=120) \
            == [("nccl", "cuda:0")]
    else:
        with pytest.raises(RuntimeError, match="rank 0 failed"):
            distributed.launch(_mesh_device, 1, timeout=120)
    with pytest.raises(ValueError, match="CPU"):
        distributed.launch(_mesh_device, 1, cpu=True, backend="nccl")


def test_nccl_takes_one_rank_a_card():
    cards = [torch.device(f"cuda:{i}") for i in (0, 1, 0, 1)]
    check_devices("nccl", cards, 2)  # two hosts of two cards
    check_devices("gloo", [torch.device("cuda:0")] * 4, 4)
    with pytest.raises(ValueError, match="gloo"):
        check_devices("nccl", [torch.device("cuda:0")] * 2, 2)
    with pytest.raises(ValueError, match="gloo"):
        check_devices("nccl", cards, 4)
    with pytest.raises(ValueError, match="CPU"):
        check_devices("nccl", [torch.device("cpu")], 1)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


def test_shards_of_rows_and_graphs_are_checked():
    assert shard_rows(16, (1, 4)) == slice(4, 8)
    with pytest.raises(ValueError, match="divisible"):
        shard_rows(10, (0, 4))
    edges = np.array([[0, 0, 1], [1, 1, 2], [2, 0, 0]])
    graph = build_graph_batch(edges, 3, 2, shard=(1, 2))
    batch = TrainBatch(graph, torch.zeros(8, 3, dtype=torch.int32),
                       torch.ones(8))
    assert shard_batch((1, 2), batch).triples.shape[0] == 4
    with pytest.raises(ValueError, match="shard"):
        shard_batch((0, 2), batch)
    # A shard summed without its mesh's group would be a third of the sum.
    params = {"W_forward": torch.zeros(2, 2, 2, 2),
              "W_backward": torch.zeros(2, 2, 2, 2),
              "W_self": torch.zeros(4, 4), "b": torch.zeros(4)}
    with pytest.raises(ValueError, match="shard"):
        encoders.apply_gcn_layer(
            params, "block", graph, torch.zeros(3, 4), fused=True,
            use_nonlinearity=False, dropout_keep=1.0, deterministic=True,
            generator=None, n_vertices=3)


# ---------------------------------------------------------------------------
# train.py
# ---------------------------------------------------------------------------

def narrow_copy(tmp_path, name="run"):
    """settings/gcn_block.exp at d = 16 (blocks of 4x4), checked and saved
    every 3 steps, saving under tmp_path/<name>."""
    src = (ROOT / "settings" / "gcn_block.exp").read_text()
    for a, b in (("InternalEncoderDimension=500",
                  "InternalEncoderDimension=16"),
                 ("CodeDimension=500", "CodeDimension=16"),
                 ("NumberOfBasisFunctions=100", "NumberOfBasisFunctions=4"),
                 ("CheckEvery=2000", "CheckEvery=3"),
                 ("BurninPhaseDuration=6000", "BurninPhaseDuration=100"),
                 ("ReportTrainLossEvery=100", "ReportTrainLossEvery=3")):
        assert a in src
        src = src.replace(a, b)
    out = tmp_path / name
    out.mkdir()
    src = re.sub(r"ExperimentName=\S+", f"ExperimentName={out / 'm'}", src)
    path = out / "gcn_block.exp"
    path.write_text(src)
    return str(path), str(out / "m")


def start_cli(settings, *flags):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("PYTHONPATH", None)
    return subprocess.Popen(
        [sys.executable, "-m", "relationprediction_torch.train",
         "--settings", settings, "--dataset", TOY, "--cpu", *flags],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish(*procs):
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"{out}\n{err}"
    return [out for out, _ in outs]


def multihost(settings, *flags):
    port = str(distributed.free_port())
    return [start_cli(settings, "--coordinator", f"localhost:{port}",
                      "--num-processes", "2", "--process-id", str(pid),
                      "--local-devices", "2", *flags) for pid in (0, 1)]


def same_state(a, b):
    for part in ("params", "opt_state"):
        for x, y in zip(tree_leaves(a[part]), tree_leaves(b[part])):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert a["step"] == b["step"]
    assert a["extra"]["pipeline_states"] == b["extra"]["pipeline_states"]


def test_cli_mesh_2_trains_on_toy(tmp_path):
    settings, ckpt = narrow_copy(tmp_path)
    (out,) = finish(start_cli(settings, "--mesh", "2",
                              "--max-iterations", "6"))
    assert "Mesh: 2 ranks over gloo" in out
    assert out.count("Dataset Toy") == 1  # rank 1 prints nothing
    assert len(re.findall(r"Tested validation score at iteration", out)) == 2
    last = re.search(r"Training done: 6 iterations .* last loss (\S+)", out)
    assert last and np.isfinite(float(last.group(1)))
    assert sorted(p.name for p in pathlib.Path(ckpt).parent.glob("*.ckpt")) \
        == ["m-3.ckpt", "m-6.ckpt"]


def test_two_processes_of_two_ranks_equal_one_process_of_four(tmp_path):
    """The process layout is not part of the result (test_multihost.py:
    68-84): the same checkpoints bit for bit; then a cluster that stops
    after step 3 and is started again with --resume reaches step 6's
    state bit for bit (:87-105)."""
    two, two_ckpt = narrow_copy(tmp_path, "two")
    four, four_ckpt = narrow_copy(tmp_path, "four")
    cut, cut_ckpt = narrow_copy(tmp_path, "cut")
    outs = finish(*multihost(two, "--max-iterations", "6"),
                  start_cli(four, "--mesh", "4", "--max-iterations", "6"),
                  *multihost(cut, "--max-iterations", "3"))
    assert "Mesh: 4 ranks over gloo" in outs[0] and not outs[1].strip()
    finish(*multihost(cut, "--max-iterations", "6", "--resume"))
    straight = checkpoint.restore_latest(two_ckpt)
    assert straight["step"] == 6
    same_state(straight, checkpoint.restore_latest(four_ckpt))
    same_state(straight, checkpoint.restore_latest(cut_ckpt))


def test_cli_vertex_sharded_without_mesh_is_a_parser_error(capsys):
    with pytest.raises(SystemExit) as exit_info:
        torch_train.main(["--settings", str(ROOT / "settings" /
                                            "gcn_block.exp"),
                          "--dataset", TOY, "--cpu", "--vertex-sharded"])
    assert exit_info.value.code == 2
    assert "--vertex-sharded requires --mesh" in capsys.readouterr().err


def test_cli_vertex_sharded_trains_and_saves_jax_checkpoints(tmp_path):
    """train.py --cpu --mesh 2 --vertex-sharded, sequential and with
    --vs-overlap, trains 6 steps on Toy with its checks, and writes
    checkpoints in the JAX package's layout (the entity table and its Adam
    moments padded to v_pad rows, gathered from the ranks) that the JAX
    package's checkpoint.restore reads."""
    from relationprediction_tpu.training import checkpoint as jax_checkpoint
    runs = {name: narrow_copy(tmp_path, name) for name in ("seq", "overlap")}
    outs = finish(
        start_cli(runs["seq"][0], "--mesh", "2", "--vertex-sharded",
                  "--max-iterations", "6"),
        start_cli(runs["overlap"][0], "--mesh", "2", "--vertex-sharded",
                  "--vs-overlap", "--max-iterations", "6"))
    for out, (_, ckpt) in zip(outs, runs.values()):
        assert "Mesh: 2 ranks over gloo, vertex-sharded" in out
        assert out.count("Dataset Toy") == 1  # rank 1 prints nothing
        assert len(re.findall(r"Tested validation score at iteration",
                              out)) == 2
        last = re.search(r"Training done: 6 iterations .* last loss (\S+)",
                         out)
        assert last and np.isfinite(float(last.group(1)))
        assert "Final test metrics" in out
        state = jax_checkpoint.restore(f"{ckpt}-6.ckpt")
        assert state["step"] == 6
        table = state["params"]["input_transform"]["W"]
        assert table.shape == (16, 16)  # 16 entities: v_pad = V on 2 ranks
        assert np.isfinite(table).all()
        assert state["opt_state"]["mu"]["input_transform"]["W"].shape \
            == table.shape


def test_cli_mesh_above_the_devices_is_a_parser_error(capsys):
    with pytest.raises(SystemExit) as exit_info:
        torch_train.main(["--settings", str(ROOT / "settings" /
                                            "gcn_block.exp"),
                          "--dataset", TOY, "--cpu", "--mesh",
                          str(10 * (os.cpu_count() or 1))])
    assert exit_info.value.code == 2
    assert "attached" in capsys.readouterr().err
