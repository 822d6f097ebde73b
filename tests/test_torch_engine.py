"""The port's serving path (Engine, schedulers, delay families and the
engine-rung measurement plane) held against the JAX package on the CPU:
the same tokens and lane states from the same carried-over parameters,
and the same epoch statistics, exactly."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.core import queues as j_queues  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Frame as JFrame  # noqa: E402
from repro.serving import engine_plane as j_plane  # noqa: E402
from repro.serving import make_replay_engine as j_replay_engine  # noqa: E402
from repro.serving import scheduler as j_sched  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.core import queues as t_queues  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import Engine as TEngine  # noqa: E402
from repro_torch.serving import Frame as TFrame  # noqa: E402
from repro_torch.serving import engine_plane as t_plane  # noqa: E402
from repro_torch.serving import make_replay_engine as t_replay_engine  # noqa: E402,E501
from repro_torch.serving import scheduler as t_sched  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"


def _engines(n_lanes=3, decode_tokens=4, max_len=64, seed=0):
    """The reference Engine on reduced qwen2.5-3b and the port's on the
    same parameters, on the CPU."""
    mj = j_build(j_configs.get("qwen2.5-3b").reduced())
    pj = j_init(mj.template(), jax.random.PRNGKey(seed))
    mt = t_models.build(t_configs.get("qwen2.5-3b").reduced())
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    return (JEngine(mj, pj, n_lanes=n_lanes, max_len=max_len,
                    decode_tokens=decode_tokens),
            TEngine(mt, pt, n_lanes=n_lanes, max_len=max_len,
                    decode_tokens=decode_tokens, device="cpu"))


def _lanes(eng):
    return [(l.status, l.stream_id, l.remaining, list(getattr(l, "out", [])),
             None if l.frame is None else l.frame.seq) for l in eng.lanes]


def _same_state(ej, et):
    assert _lanes(ej) == _lanes(et)
    assert ej.utilization == et.utilization
    np.testing.assert_array_equal(np.asarray(ej.cache["len"]),
                                  et.cache["len"].numpy())


def _tokens(results):
    return sorted((r.stream_id, tuple(int(x) for x in r.tokens))
                  for r in results)


def test_engine_admit_decode_preempt_match_reference():
    ej, et = _engines()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (6, 11, 3)]
    for i, toks in enumerate(prompts[:2]):
        assert ej.admit(JFrame(i, 0.0, 0.0, seq=i), toks)
        assert et.admit(TFrame(i, 0.0, 0.0, seq=i), toks)
        _same_state(ej, et)
    assert _tokens(ej.decode_tick()) == _tokens(et.decode_tick())
    _same_state(ej, et)
    assert ej.preempt_stream(0) == et.preempt_stream(0) == 1
    _same_state(ej, et)
    # The freed lane takes a new frame over the stale rows of the old one.
    assert ej.admit(JFrame(7, 0.0, 0.0, seq=2), prompts[2], lane=0)
    assert et.admit(TFrame(7, 0.0, 0.0, seq=2), prompts[2], lane=0)
    assert not et.admit(TFrame(8, 0.0, 0.0), prompts[2], lane=0)
    _same_state(ej, et)
    done_j, done_t = [], []
    for _ in range(6):
        done_j += ej.decode_tick()
        done_t += et.decode_tick()
        _same_state(ej, et)
    assert _tokens(done_j) == _tokens(done_t)
    assert len(done_t) == 2 and et.utilization == 0.0
    assert et._steps == ej._steps


def test_engines_serve_padded_vocabulary_ids():
    """A known fault of the reference, followed by the port (ROADMAP queue
    3): both Engines take the argmax over all padded_vocab logit columns,
    so an id at or above vocab, which is no token, can be served. Reduced
    qwen2.5-3b with vocab 200 (padded to 256) and unembedding column 250
    planted as 10x the column of the token the unplanted model serves
    first: both engines then serve id 250, and the same tokens."""
    import dataclasses
    cfg_j = dataclasses.replace(j_configs.get("qwen2.5-3b").reduced(),
                                vocab=200)
    cfg_t = dataclasses.replace(t_configs.get("qwen2.5-3b").reduced(),
                                vocab=200)
    assert cfg_j.padded_vocab == cfg_t.padded_vocab == 256
    mj, mt = j_build(cfg_j), t_models.build(cfg_t)
    tree = jax.tree.map(np.asarray, j_init(mj.template(),
                                           jax.random.PRNGKey(3)))
    prompt = np.arange(5, 12, dtype=np.int32)
    plain = TEngine(mt, params_from_numpy(tree, "cpu"), n_lanes=2,
                    max_len=32, decode_tokens=3, device="cpu")
    first = int(torch.argmax(plain.prefill_lane(prompt, 0)))
    assert first < cfg_t.vocab
    w = np.array(tree["unembed"]["w"])
    w[:, 250] = 10.0 * w[:, first]
    tree["unembed"]["w"] = w
    ej = JEngine(mj, jax.tree.map(jnp.asarray, tree), n_lanes=2,
                 max_len=32, decode_tokens=3)
    et = TEngine(mt, params_from_numpy(tree, "cpu"), n_lanes=2, max_len=32,
                 decode_tokens=3, device="cpu")
    for eng, frame in ((ej, JFrame(0, 0.0, 0.0, seq=0)),
                       (et, TFrame(0, 0.0, 0.0, seq=0))):
        assert eng.admit(frame, prompt)
        eng.decode_tick()
    assert ej.lanes[0].out[0] == et.lanes[0].out[0] == 250
    assert list(ej.lanes[0].out) == list(et.lanes[0].out)


def test_engine_batched_decode_matches_sequential():
    """Two lanes decoding together give the tokens of one lane alone."""
    _, solo = _engines(n_lanes=1)
    _, pair = _engines(n_lanes=2)
    a = np.arange(2, 12, dtype=np.int32)
    solo.admit(TFrame(0, 0, 0), a)
    pair.admit(TFrame(0, 0, 0), a)
    pair.admit(TFrame(1, 0, 0), np.arange(30, 45, dtype=np.int32))
    out_solo, outs = None, {}
    for _ in range(6):
        for r in solo.decode_tick():
            out_solo = r.tokens
        for r in pair.decode_tick():
            outs[r.stream_id] = r.tokens
    np.testing.assert_array_equal(outs[0], out_solo)


def _steady(n=4, lam=0.6, mu=2.0, p=0.8):
    pol = (np.arange(n) % 2).astype(np.int64)          # FCFS and LCFSP
    return np.full(n, lam), np.full(n, mu), np.full(n, p), pol


def _assert_epochs_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "trace":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


@pytest.mark.parametrize("delay_model", ["mm1", "weibull"])
def test_engine_epoch_on_reduced_qwen_equals_reference(delay_model):
    ej, et = _engines(n_lanes=4, decode_tokens=2)
    lam, mu, p, pol = _steady()
    kw = dict(epoch_duration=30.0, seed=3, t=1, frames_cap=12,
              delay_model=delay_model, collect_trace=True)
    a = j_plane.measure_engine_epoch(ej, lam, mu, p, pol, **kw)
    b = t_plane.measure_engine_epoch(et, lam, mu, p, pol, **kw)
    _assert_epochs_equal(a, b)
    assert b["engine_steps"] > 0 and b["preempts"][pol == 1].sum() > 0
    assert et.utilization == 0.0                     # drained


@pytest.mark.parametrize("delay_model", ["mm1", "lognormal"])
def test_engine_epoch_on_replay_engine_equals_reference(delay_model):
    lam, mu, p, pol = _steady(n=6)
    active = np.array([1, 1, 0, 1, 1, 1], np.float64)
    kw = dict(epoch_duration=120.0, seed=9, t=2, frames_cap=64,
              delay_model=delay_model, collect_samples=16,
              collect_trace=True, active=active)
    a = j_plane.measure_engine_epoch(j_replay_engine(6), lam, mu, p, pol,
                                     **kw)
    b = t_plane.measure_engine_epoch(t_replay_engine(6, device="cpu"), lam,
                                     mu, p, pol, **kw)
    _assert_epochs_equal(a, b)
    assert b["n_frames"][2] == 0 and b["aopi"][2] == 0


def test_replay_engine_tokens_and_lane_refusals():
    eng = t_replay_engine(2, decode_tokens=3, device="cpu")
    assert eng.model.vocab == 32
    assert eng.admit(TFrame(0, 0, 0), np.arange(6, dtype=np.int32), lane=1)
    assert not eng.admit(TFrame(1, 0, 0), np.arange(6, dtype=np.int32),
                         lane=1)
    done = []
    for _ in range(4):
        done += eng.decode_tick()
    assert len(done) == 1 and len(done[0].tokens) == 4
    assert ((done[0].tokens >= 0) & (done[0].tokens < 32)).all()
    with pytest.raises(ValueError, match="lanes"):
        t_plane.measure_engine_epoch(eng, *_steady(n=3),
                                     epoch_duration=10.0)


def test_frame_tokens_and_draws_equal_reference():
    for args in ((3, 5, 32), (0, 0, 256), (7, 191, 152_064)):
        np.testing.assert_array_equal(t_plane._frame_tokens(*args),
                                      j_plane._frame_tokens(*args))
    lam, mu, _, _ = _steady(n=3)
    live = np.array([True, False, True])
    for dm in t_queues.DELAY_MODELS:
        kw = dict(delay_model=dm, seed=4, t=3, frames_cap=20)
        for x, y in zip(j_plane.draw_streams(lam, mu, live, **kw),
                        t_plane.draw_streams(lam, mu, live, **kw)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="delay_model"):
        t_queues.validate_delay_model("pareto")
    assert t_queues.validate_delay_model("auto", allow_auto=True) == "auto"
    assert t_queues.DELAY_MODELS == j_queues.DELAY_MODELS


def test_scheduler_copy_behaves_as_reference():
    for mod, frame in ((j_sched, j_sched.Frame), (t_sched, t_sched.Frame)):
        q = mod.StreamQueue(0, mod.LCFSP)
        assert q.on_arrival(frame(0, 0.0, 1.0))
        assert q.on_arrival(frame(0, 1.0, 2.0, seq=1))
        assert len(q) == 1 and q.pop().seq == 1
        f = mod.StreamQueue(1, mod.FCFS)
        assert not f.on_arrival(frame(1, 0.0, 1.0, seq=0))
        f.on_arrival(frame(1, 0.5, 1.5, seq=1))
        assert [f.pop().seq, f.pop().seq] == [0, 1]
    tj, tt = j_sched.AoPITracker(2), t_sched.AoPITracker(2)
    for tr in (tj, tt):
        tr.on_result(0, 0.5, True, 1.0)
        tr.on_result(0, 1.5, False, 2.5)
        tr.on_result(1, 0.2, True, 3.0)
    assert tj.overall(4.0) == tt.overall(4.0)


def test_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_replay_engine(2)
    model = t_models.build(t_configs.get("qwen2.5-3b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(model, {}, n_lanes=2, max_len=8)


def test_port_imports_neither_jax_nor_repro():
    """The whole port (models and serving included) imports, builds a
    reduced engine and serves a frame with jax and repro unimportable."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, torch\n"
        "import repro_torch, repro_torch.configs, repro_torch.models, "
        "repro_torch.serving, repro_torch.core.lbcd, "
        "repro_torch.core.baselines, repro_torch.core.energy, "
        "repro_torch.kernels.slot_solver.ops\n"
        "from repro_torch import configs, models, serving\n"
        "m = models.build(configs.get('qwen2.5-3b').reduced())\n"
        "p = models.common.init_params(m.template(), torch.Generator(), "
        "device='cpu')\n"
        "e = serving.Engine(m, p, n_lanes=2, max_len=16, device='cpu')\n"
        "assert e.admit(serving.Frame(0, 0.0, 0.0), np.arange(6))\n"
        "e.decode_tick()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
