"""The port's training loop on the CPU: ``Trainer`` (history, trace,
heartbeat, registry, auto-recovery, resume), ``Checkpointer``, the
tracing sinks, ``maybe_profile`` and the ``launch.train`` CLI; against
the JAX package where the two must agree.

* Three ``Trainer`` steps with probes and the democratization snapshot,
  from JAX's weights, the port replaying JAX's act-quant decisions
  (``test_torch_probes._port_replay``; remat off on both sides): every
  history value within HIST_TOL of JAX's, relative above 1 and absolute
  below.
* Telemetry off (``probes=False``, a tracer, a registry, a history file):
  the step dispatches the same aten ops as a bare ``make_train_step``, and
  a ``Trainer`` iteration adds only the metrics' stack and its one copy
  to the host (counted with a ``TorchDispatchMode``).
* Checkpoints: the ``params/...`` keys are JAX's letter for letter and
  restore through JAX's ``Checkpointer`` bit for bit; bf16 round trips;
  resume after k steps gives the uninterrupted run's state bit for bit.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import checkpointer as jckpt
from repro.configs import registry as jregistry
from repro.data import pipeline as jpipeline
from repro.models import api as japi
from repro.train import trainer as jtrainer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.pipeline import DataConfig, SyntheticSource, host_batch
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw
from repro_torch.telemetry import tracing
from repro_torch.telemetry.metrics import ManualClock, MetricsRegistry, validate_snapshot
from repro_torch.telemetry.tracing import JsonlSink, ListSink, TrainTracer
from repro_torch.train import trainer
from repro_torch.train.trainer import Trainer, TrainerConfig, _write_atomic
from test_torch_probes import _port_replay
from test_torch_train import _jax_recording
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

HIST_TOL = 1e-5
CPU = "cpu"


def _cfgs(mode="pquant", **kw):
    jcfg = jregistry.reduced(jregistry.get_config("pquant-100m", quant_mode=mode))
    cfg = registry.reduced(registry.get_config("pquant-100m", quant_mode=mode))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _tiny(mode="pquant"):
    qc = QuantConfig(mode=mode, r=16 if mode == "pquant" else 0, num_experts=1)
    return ModelConfig(name=f"tiny-{mode}", family="decoder", n_layers=2, d_model=32,
                       n_heads=4, n_kv_heads=2, d_ff=48, vocab_size=64, quant=qc)


def _data_iter(cfg, steps, seq=16, batch=4, seed=0, start=0):
    src = SyntheticSource(cfg.vocab_size, seed=seed)
    dcfg = DataConfig(seq_len=seq, global_batch=batch, seed=seed)
    for s in range(start, steps):
        yield s, host_batch(src, dcfg, s)


def _trainer(cfg, steps_in_data, **tkw):
    tkw.setdefault("total_steps", steps_in_data)
    tkw.setdefault("log_every", 1000)
    tkw.setdefault("heartbeat_path", None)
    return Trainer(cfg, TrainerConfig(**tkw), _data_iter(cfg, steps_in_data), device=CPU)


def _state_arrays(state) -> dict:
    tree = {"params": state.params, "mu": state.opt.mu, "nu": state.opt.nu}
    out = {"/".join(map(str, p)): t.numpy().copy() for p, t in adamw.tree_paths(tree)}
    out["step"] = state.opt.step.numpy().copy()
    return out


# ---------------------------------------------------------------------------
# the Trainer against JAX's
# ---------------------------------------------------------------------------


def test_trainer_history_matches_jax():
    """Three steps, probes on: every history value of the port's Trainer
    against JAX's Trainer, from JAX's weights and the same pipeline batches.
    The democratization snapshot runs after step 0 (lr 0), where both
    packages hold the same parameters: after an update, Adam may move an
    element of near-zero gradient either way (``test_torch_train``), and
    the log of a squared near-zero weight moves the kurtosis by more than
    HIST_TOL (``test_torch_probes`` holds the snapshot on equal
    parameters)."""
    jcfg, cfg = _cfgs(dtype="float32", remat=False)
    steps = 3
    tkw = dict(total_steps=steps, log_every=1000, probes=True, sensitivity_every=3,
               heartbeat_path=None)
    src = jpipeline.SyntheticSource(jcfg.vocab_size, seed=0)
    dcfg = jpipeline.DataConfig(seq_len=16, global_batch=4)
    jbatches = [(s, jpipeline.host_batch(src, dcfg, s)) for s in range(steps)]
    jtr = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(**tkw), iter(jbatches))
    params = jax.tree.map(np.asarray, jtr.state.params)
    record = []
    with _jax_recording(record):
        jhist = jtr.run()
    n = len(record) // steps
    records = [record[i * n:(i + 1) * n] for i in range(steps)]

    tr = Trainer(cfg, TrainerConfig(**tkw), _data_iter(cfg, steps), device=CPU)
    with torch.no_grad():
        for t, a in zip(adamw.tree_leaves(tr.state.params), jax.tree.leaves(params)):
            t.copy_(torch.from_numpy(a.copy()))
    orig, calls = tr.step_fn, iter(records)

    def replayed(state, batch):
        with _port_replay(next(calls)):
            return orig(state, batch)

    tr.step_fn = replayed
    hist = tr.run()
    assert len(hist) == len(jhist) == steps
    assert "demo_score_ffn1" in hist[0] and "demo_score_ffn1" not in hist[2]
    for got, want in zip(hist, jhist):
        assert set(got) == set(want) and got["step"] == want["step"]
        for k, w in want.items():
            if k in ("step", "step_time_s"):
                continue
            assert abs(got[k] - w) <= HIST_TOL * max(1.0, abs(w)), (got["step"], k, got[k], w)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _clone(state):
    p = adamw.tree_map(torch.clone, state.params)
    return trainer.TrainState(p, adamw.init_adamw(p))


def test_trainer_with_telemetry_launches_the_bare_steps_ops(tmp_path):
    """The port's form of ``test_trainer_with_telemetry_lowers_identically``:
    with ``probes=False`` and a registry, a tracer and a history file
    attached, the Trainer's step dispatches the bare step's aten ops, and a
    whole Trainer iteration adds the batch's conversion, the metrics' stack
    and one copy to the host, nothing else."""
    cfg = _cfgs()[1]
    state = trainer.init_train_state(0, cfg, device=CPU)
    batch = next(_data_iter(cfg, 1))[1]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    s_default, s_off = _clone(state), _clone(state)
    with _Ops() as bare_default:
        trainer.make_train_step(cfg, 10)(s_default, tb)
    with _Ops() as bare_off:
        trainer.make_train_step(cfg, 10, probes=False)(s_off, tb)
    tr = Trainer(cfg, TrainerConfig(total_steps=10, probes=False, heartbeat_path=None,
                                    history_path=str(tmp_path / "h.jsonl")),
                 iter([(0, batch)]), metrics=MetricsRegistry(), tracer=TrainTracer(ListSink()),
                 device=CPU)
    s_tr = _clone(state)
    with _Ops() as stepped:
        tr.step_fn(s_tr, tb)
    tr.state = _clone(state)
    with _Ops() as iteration:
        tr.run()
    assert bare_default.ops == bare_off.ops == stepped.ops
    # the batch's two arrays become tensors; then the step; then one copy
    assert iteration.ops == (["aten.lift_fresh.default"] * 2 + stepped.ops
                             + ["aten.stack.default", "aten._local_scalar_dense.default"])
    s_probed = _clone(state)
    with _Ops() as probed:
        trainer.make_train_step(cfg, 10, probes=True)(s_probed, tb)
    assert len(probed.ops) > len(stepped.ops)


@pytest.mark.parametrize("mode,expect,absent", [
    ("bitnet", ("qat_flip_ffn1", "qat_clip_act"), ("qat_clip_w8", "qat_branch_share8")),
    ("none", ("qat_flip_ffn1",), ("qat_clip_act", "qat_clip_w8")),
    ("bitnet158", ("qat_flip_attn", "qat_clip_act"), ("qat_clip_w8",)),
])
def test_probe_metrics_finite_for_baselines(mode, expect, absent):
    cfg = _tiny(mode)
    tr = _trainer(cfg, 2, probes=True)
    hist = tr.run()
    for k in expect:
        assert all(np.isfinite(h[k]) for h in hist), k
    for k in absent:
        assert k not in hist[0], k


# ---------------------------------------------------------------------------
# lifecycle: history, trace, heartbeat, registry, recovery, resume
# ---------------------------------------------------------------------------


def test_probes_trace_history_heartbeat(tmp_path):
    trace, hist_path, hb = tmp_path / "trace.jsonl", tmp_path / "history.jsonl", tmp_path / "hb"
    tr = _trainer(_tiny(), 3, log_every=10, probes=True, sensitivity_every=2,
                  trace_path=str(trace), history_path=str(hist_path), heartbeat_path=str(hb))
    assert tr.run() == [] and tr.history == []  # streamed, not held
    hist = [json.loads(line) for line in hist_path.read_text().splitlines()]
    assert [h["step"] for h in hist] == [0, 1, 2]
    for h in hist:
        for k in ("qat_clip_act", "qat_branch_share8", "qat_flip_attn", "qat_flip_ffn1",
                  "qat_clip_w8", "qat_gnorm_share8", "qat_scale_drift_absmean",
                  "qat_scale_drift_absmax"):
            assert np.isfinite(h[k]), k
        assert 0.0 <= h["qat_clip_act"] <= 1.0 and 0.0 <= h["qat_branch_share8"] <= 1.0
    assert "demo_score_ffn1" in hist[0] and "demo_score_ffn1" in hist[2]
    assert "demo_score_ffn1" not in hist[1]
    evs = [json.loads(line) for line in trace.read_text().splitlines()]
    kinds = [e["event"] for e in evs]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("step") == 3 and "heartbeat" in kinds
    assert [e["t"] for e in evs] == sorted(e["t"] for e in evs)
    assert hb.read_text() == "2"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    snap = json.loads(json.dumps(tr.snapshot()))
    validate_snapshot(snap)
    assert snap["counters"]["train_steps_total"] == 3
    assert snap["histograms"]["train_step_seconds"]["count"] == 3
    assert snap["gauges"]["train_step"] == 2 and np.isfinite(snap["gauges"]["train_loss"])
    assert "qat_clip_act" in snap["gauges"] and "demo_score_ffn1" in snap["gauges"]
    assert "train_steps_total 3" in tr.metrics.prometheus_text()


def test_auto_recovery_on_nan(tmp_path):
    """Upstream's recovery case: checkpoints every 5 steps, a non-finite
    loss at the 8th step (step 7), after the step wrote non-finite values
    into the master: every leaf comes back from the checkpoint of step 5
    (optimizer step 6), so ``from_step`` is 6."""
    trace = tmp_path / "trace.jsonl"
    tr = _trainer(_tiny(), 30, total_steps=12, ckpt_every=5, ckpt_dir=str(tmp_path / "ck"),
                  trace_path=str(trace))
    orig, hits = tr.step_fn, {"n": 0}

    def poisoned(state, batch):
        state, m = orig(state, batch)
        hits["n"] += 1
        if hits["n"] == 8:
            adamw.tree_leaves(state.params)[0].fill_(float("nan"))
            m = dict(m, loss=torch.tensor(float("nan")))
        return state, m

    tr.step_fn = poisoned
    hist = tr.run()
    assert tr.recoveries == 1
    assert all(np.isfinite(h["loss"]) for h in hist if "event" not in h)
    recs = [h for h in hist if h.get("event") == "recovery"]
    assert len(recs) == 1 and recs[0]["from_step"] == 6 and recs[0]["recoveries"] == 1
    assert all(torch.isfinite(p).all() for p in adamw.tree_leaves(tr.state.params))
    evs = [json.loads(line) for line in trace.read_text().splitlines()]
    rec_ev = next(e for e in evs if e["event"] == "recovery")
    assert rec_ev["from_step"] == 6 and "restore" in [e["event"] for e in evs]
    snap = tr.snapshot()
    assert snap["counters"]["train_recoveries_total"] == 1
    assert snap["counters"]["train_restores_total"] == 1
    assert snap["counters"]["train_checkpoints_total"] >= 2


def test_resume_is_exact(tmp_path):
    """2k uninterrupted steps against k steps, a checkpoint, a new Trainer
    and k more: the same parameters, moments and step count, bit for bit
    (bf16 forward, probes on)."""
    cfg, k = _cfgs()[1], 2
    ck = str(tmp_path / "ck")
    whole = _trainer(cfg, 2 * k, probes=True)
    whole.run()
    first = Trainer(cfg, TrainerConfig(total_steps=2 * k, probes=True, ckpt_dir=ck,
                                       heartbeat_path=None), _data_iter(cfg, k), device=CPU)
    first.run()
    second = Trainer(cfg, TrainerConfig(total_steps=2 * k, probes=True, ckpt_dir=ck,
                                        heartbeat_path=None), _data_iter(cfg, 2 * k), device=CPU)
    assert second.start_step == k
    hist = second.run()
    assert [h["step"] for h in hist] == list(range(k, 2 * k))
    want, got = _state_arrays(whole.state), _state_arrays(second.state)
    assert set(want) == set(got) and int(got["step"]) == 2 * k
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_trainer_needs_a_device_or_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_tiny(), TrainerConfig(total_steps=1), iter(()))


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------


def test_checkpoint_keys_and_jax_collision(tmp_path):
    """The port keys the train state ``params/<path>`` (JAX's keys, letter
    for letter), ``opt/step``, ``opt/mu/<path>`` and ``opt/nu/<path>``.
    JAX's key builder names no NamedTuple field, so its ``mu`` and ``nu``
    leaves share keys (a reference caveat)."""
    jcfg, cfg = _cfgs()
    jstate = jax.eval_shape(lambda: jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg)[0])
    jkeys = [k for k, _ in jckpt._flatten(jstate._asdict())[0]]
    state = trainer.init_train_state(0, cfg, device=CPU)
    Checkpointer(str(tmp_path)).save(0, {"params": state.params, "opt": state.opt}, blocking=True)
    keys = json.loads((tmp_path / "step_0" / "manifest.json").read_text())["keys"]
    assert len(set(keys)) == len(keys)
    assert [k for k in keys if k.startswith("params/")] == \
        [k for k in jkeys if k.startswith("params/")]
    n = len(adamw.tree_leaves(state.params))
    assert keys[0] == "opt/step" and len(keys) == 1 + 3 * n
    assert {k.split("/", 2)[1] for k in keys if k.startswith("opt/") and k != "opt/step"} == \
        {"mu", "nu"}
    assert len(set(jkeys)) < len(jkeys)  # JAX: "opt//<path>" twice per leaf


def test_port_checkpoint_restores_through_jax_bit_for_bit(tmp_path):
    jcfg, cfg = _cfgs()
    jparams = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0), jcfg)[0])
    state = trainer.init_train_state(3, cfg, device=CPU)
    params = dict(state.params, extra={"bf": torch.randn(3, 5).to(torch.bfloat16)})
    Checkpointer(str(tmp_path)).save(7, {"params": params, "opt": state.opt}, blocking=True)
    like = dict(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jparams),
                extra={"bf": jnp.zeros((3, 5), jnp.bfloat16)})
    out = jckpt.Checkpointer(str(tmp_path)).restore({"params": like})["params"]
    flat = adamw.tree_paths(params)
    jflat = jax.tree_util.tree_flatten_with_path(out)[0]
    assert ["/".join(map(str, p)) for p, _ in flat] == \
        ["/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in p) for p, _ in jflat]
    for (path, t), (_, a) in zip(flat, jflat):
        if t.dtype == torch.bfloat16:
            assert a.dtype == jnp.bfloat16
            np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                          t.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(np.asarray(a), t.numpy(), err_msg=str(path))


def test_bf16_round_trips_and_jax_bf16_reads_back(tmp_path):
    x = torch.randn(4, 6).to(torch.bfloat16)
    tree = {"a": {"b": x}, "n": [torch.arange(3, dtype=torch.int32)]}
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(1, tree, blocking=True)
    like = {"a": {"b": torch.zeros(4, 6, dtype=torch.bfloat16)}, "n": [torch.zeros(3, dtype=torch.int32)]}
    out = ck.restore(like)
    assert out is like and torch.equal(like["a"]["b"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(like["n"][0], tree["n"][0])
    jx = jnp.asarray(np.asarray(x.float().numpy()), jnp.bfloat16)
    jckpt.Checkpointer(str(tmp_path / "jax")).save(2, {"a": {"b": jx}}, blocking=True)
    got = Checkpointer(str(tmp_path / "jax")).restore({"a": {"b": torch.zeros(4, 6, dtype=torch.bfloat16)}})
    assert torch.equal(got["a"]["b"].view(torch.int16),
                       torch.from_numpy(np.asarray(jx).view(np.int16).copy()))


def test_async_save_snapshots_before_returning(tmp_path):
    """The host copy is finished when ``save`` returns: the training step
    may overwrite the tensors in place while the writer runs."""
    w = torch.arange(10, dtype=torch.float32)
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(1, {"w": w})
    w.fill_(-1.0)  # the next in-place step
    ck.wait()
    for s in (2, 3):
        ck.save(s, {"w": w})
    ck.wait()
    assert ck.all_steps() == [2, 3]  # keep=2
    out = ck.restore({"w": torch.zeros(10)}, step=3)
    assert torch.equal(out["w"], w)
    os.makedirs(tmp_path / "step_9.tmp")
    assert ck.latest_step() == 3  # a half-written save is never a checkpoint


def test_restore_errors(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore({"w": torch.zeros(2)})
    ck.save(0, {"w": torch.zeros(2)}, blocking=True)
    with pytest.raises(ValueError, match="shape mismatch for w"):
        ck.restore({"w": torch.zeros(3)})
    with pytest.raises(KeyError):
        ck.restore({"v": torch.zeros(2)})


def test_writer_error_surfaces_in_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    ck.save(0, {"w": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # raised once


# ---------------------------------------------------------------------------
# tracing sinks, heartbeat, profiler bracket
# ---------------------------------------------------------------------------


def test_train_tracer_jsonl_round_trip_on_manual_clock(tmp_path):
    path = tmp_path / "trace.jsonl"
    clock = ManualClock(start=5.0)
    tracer = TrainTracer(JsonlSink(path), clock=clock)
    tracer.emit("run_start", step=0, arch="t", total_steps=3)
    clock.advance(1.0)
    tracer.emit("step", step=1, loss=2.5, skipme=None)
    tracer.emit("run_end", step=3, recoveries=0)
    tracer.close()
    evs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [e["event"] for e in evs] == ["run_start", "step", "run_end"]
    assert [e["t"] for e in evs] == [5.0, 6.0, 6.0]
    assert evs[0]["arch"] == "t" and evs[1]["step"] == 1 and "skipme" not in evs[1]
    assert tracer.events == 3
    sink = ListSink()
    TrainTracer(sink, clock=clock).emit("heartbeat", step=4)
    assert sink.records == [{"t": 6.0, "event": "heartbeat", "step": 4}]


def test_heartbeat_replaces_atomically(tmp_path):
    path = str(tmp_path / "hb")
    _write_atomic(path, "7")
    _write_atomic(path, "8")
    assert open(path).read() == "8"
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_maybe_profile_writes_one_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv(tracing.PROFILE_DIR_ENV, str(tmp_path))
    with tracing.maybe_profile("train"):
        with tracing.maybe_profile("inner"):  # nested: a no-op
            with tracing.annotate("train/grads"):
                torch.ones(4).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("train-")
    names = {e.get("name") for e in json.loads((tmp_path / files[0]).read_text())["traceEvents"]}
    assert {"repro/train", "train/grads"} <= names
    monkeypatch.delenv(tracing.PROFILE_DIR_ENV)
    with tracing.maybe_profile("train"):
        pass
    assert len(os.listdir(tmp_path)) == 1


# ---------------------------------------------------------------------------
# launcher, example and bench
# ---------------------------------------------------------------------------


def test_launch_train_cli_end_to_end(tmp_path):
    out = tmp_path / "run"
    argv = ["--arch", "pquant-100m", "--reduced", "--steps", "4", "--seq-len", "16",
            "--global-batch", "2", "--device", "cpu", "--probes", "--sensitivity-every", "2",
            "--ckpt-dir", str(out / "ck"), "--ckpt-every", "2", "--log-every", "1",
            "--history-out", str(out / "h.json"), "--trace-jsonl", str(out / "t.jsonl"),
            "--metrics-out", str(out / "m.json")]
    os.makedirs(out)
    hist = launch_train.main(argv)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert json.load(open(out / "h.json")) == hist
    validate_snapshot(json.load(open(out / "m.json")))
    assert Checkpointer(str(out / "ck")).latest_step() == 4
    # the same flags with more steps: resumes from the last checkpoint
    more = ["6" if a == "4" and argv[i - 1] == "--steps" else a for i, a in enumerate(argv)]
    assert [h["step"] for h in launch_train.main(more)] == [4, 5]
    kinds = [json.loads(line)["event"] for line in open(out / "t.jsonl")]
    assert "restore" in kinds


@pytest.mark.parametrize("extra", [["--coordinator", "localhost:1234"], ["--num-processes", "2"]])
def test_launch_train_multi_process_is_not_ported(extra):
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        launch_train.main(["--arch", "pquant-100m", "--reduced", "--device", "cpu"] + extra)


def test_stability_bench_smoke_emits_validated_artifacts(tmp_path):
    from benchmarks import torch_bench_stability

    metrics_out, trace_out = tmp_path / "m.json", tmp_path / "t.jsonl"
    out = torch_bench_stability.run(steps=4, smoke=True, metrics_out=str(metrics_out),
                                    trace_out=str(trace_out), device=CPU)
    assert set(out) == {"bitnet", "pquant"}
    snap = json.load(open(metrics_out))
    validate_snapshot(snap)
    assert snap["counters"]["train_steps_total"] > 0
    assert any(k.startswith("qat_") for k in snap["gauges"])
    kinds = {json.loads(line)["event"] for line in trace_out.read_text().splitlines()}
    assert {"run_start", "step", "run_end"} <= kinds
