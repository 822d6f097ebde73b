"""The rest of the multi-rank port over gloo ranks on the CPU:
``training.compression.compressed_psum`` on 4 ranks against the JAX
package's ``compressed_psum`` under ``shard_map`` on 4 fake XLA devices (a
subprocess), bitwise; the sweep's ``"shard_map"`` backend on 4 ranks and
``"fleet"`` over 4 CPU devices against ``"loop"``, bitwise, on a suite
with ``camera_churn`` whose 3 scenarios do not divide 4; and
``launch.train.run`` on 2 ranks against one process (losses within 1e-5
relative).
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402

LENGTHS = (64, 1000)
BLOCK = 256


def _reference_psum(xs: dict) -> dict:
    """repro's compressed_psum under shard_map on 4 fake CPU devices, in a
    subprocess (this process keeps its one device)."""
    code = textwrap.dedent(f"""
        import os, sys, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        sys.path.insert(0, {os.path.join(workers.REPO, 'src')!r})
        import jax, jax.experimental
        if not hasattr(jax.experimental, "enable_x64"):
            jax.experimental.enable_x64 = jax.enable_x64
        import numpy as np
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.training.compression import compressed_psum
        mesh = Mesh(np.asarray(jax.devices()[:4]), ("i",))
        data = np.load(sys.argv[1])
        out = {{}}
        for key in data.files:
            fn = jax.shard_map(lambda x: compressed_psum(x, "i",
                                                         block={BLOCK}),
                               mesh=mesh, in_specs=P("i"), out_specs=P("i"))
            out[key] = np.asarray(jax.jit(fn)(data[key]))
        np.savez(sys.argv[2], **out)
    """)
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "x.npz"), os.path.join(d, "y.npz")
        np.savez(src, **xs)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, "-c", code, src, dst],
                              capture_output=True, text=True, timeout=300,
                              env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return dict(np.load(dst))


def test_compressed_psum_matches_shard_map_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    xs = {f"x_{n}": (rng.standard_normal((4, n)) *
                     rng.uniform(0.1, 10.0, (4, 1))).astype(np.float32)
          for n in LENGTHS}
    want = _reference_psum(xs)
    outs = workers.spawn("psum", 4, tmp_path,
                         dict(lengths=list(LENGTHS), block=BLOCK), xs)
    for n in LENGTHS:
        x = xs[f"x_{n}"]
        exact = x.mean(axis=0)
        for r, out in enumerate(outs):
            got = out[f"out_{n}"]
            np.testing.assert_array_equal(got, want[f"x_{n}"][r])
            # Per block, within one int8 step of the shared scale.
            pad = (-n) % BLOCK
            gmax = np.abs(np.pad(x, ((0, 0), (0, pad)))).reshape(
                4, -1, BLOCK).max(axis=(0, 2))
            bar = np.repeat(gmax / 127.0, BLOCK)[:n]
            assert np.all(np.abs(got - exact) <= bar)


SUITE = dict(names=["steady_ar1", "camera_churn", "server_outage"],
             dims=dict(n_cameras=8, n_servers=3, n_slots=6, seed=0,
                       churn_t0=1))


def test_sweep_backends_equal_loop_bitwise(tmp_path):
    from repro_torch import scenarios
    outs = workers.spawn("sweep", 4, tmp_path, SUITE, timeout=400)
    want = workers.sweep_series(scenarios, SUITE, "loop", "cpu")
    fleet = workers.sweep_series(scenarios, SUITE, "fleet", "cpu",
                                 devices=["cpu"] * 4)
    assert str(want["backend"]) == "loop"
    assert str(fleet["backend"]) == "fleet[4]"
    keys = [k for k in want if k != "backend"]
    assert len(keys) == 12
    for key in keys:
        assert want[key].shape[0] == 3 and np.all(np.isfinite(want[key]))
        np.testing.assert_array_equal(fleet[key], want[key])
        for out in outs:
            assert str(out["backend"]) == "shard_map[4]"
            np.testing.assert_array_equal(out[key], want[key])


RUN = dict(steps=3, batch=4, seq=32, n_microbatches=2)


def test_train_launcher_two_ranks_match_one(tmp_path):
    cfg = t_configs.get("qwen2.5-3b").reduced()
    one = t_train.run(cfg, device="cpu", log_every=0, **RUN)
    outs = workers.spawn("launch", 2, tmp_path,
                         dict(arch="qwen2.5-3b", run=RUN))
    for out in outs:
        assert json.loads(str(out["mesh"]).replace("'", '"')) == \
            {"data": 2, "model": 1}
        np.testing.assert_allclose(out["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norms"], one["grad_norms"],
                                   rtol=1e-5)


def test_sweep_shard_map_needs_a_group():
    from repro_torch import scenarios
    st = scenarios.suite(SUITE["names"][:1], device="cpu", **SUITE["dims"])
    with pytest.raises(ValueError):
        scenarios.sweep(st, backend="shard_map", device="cpu",
                        policies=["min"])
