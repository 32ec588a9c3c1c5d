"""int8 gradient compression in the port (``optim/compression.py``)
against the JAX package's ``repro/optim/compression.py``.

The three single-process tests are twins of ``tests/test_compression.py``'s
on numpy draws from a seed, each held to the JAX functions on the same
input: the int8 codes and their scales exactly (the same f32 division,
round-half-to-even and clip), the dequantized values and error-feedback
sums within 1e-6 of the reference's (f32 products and sums), and each
reference bound as that test states it.  The compressed all-reduce runs
on 4 gloo ranks on the CPU (``tests/torch_ranks.py``, 180 s limit), the
JAX side on 4 forced host devices in a subprocess, and the two means
agree within the reference's bound, atol 8e-4.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from repro.optim import compression as jcomp
from repro_torch.optim.compression import (CompressedReducer, compression_error,
                                           dequantize, quantize)
from tests.test_distributed import run_with_devices
from tests.torch_ranks import compressed_mean, spawn


def test_quantize_roundtrip_error_bound():
    g = np.random.default_rng(0).standard_normal((256, 64)).astype(np.float32)
    q, s = quantize({"w": torch.from_numpy(g)})
    jq, js = jcomp.quantize({"w": jnp.asarray(g)})
    assert q["w"].dtype == torch.int8
    np.testing.assert_array_equal(q["w"].numpy(), np.asarray(jq["w"]))
    assert s["w"].item() == float(js["w"])
    back = dequantize(q, s)["w"].numpy()
    np.testing.assert_allclose(back, np.asarray(jcomp.dequantize(jq, js)["w"]),
                               rtol=0, atol=1e-6)
    # symmetric int8: error <= scale/2 = max_abs / 254
    assert np.abs(back - g).max() <= np.abs(g).max() / 254 + 1e-6


def test_error_feedback_accumulates_to_true_sum():
    """sum of compressed(g_t) -> sum of g_t when error feedback carries the
    residuals; the port's running sum is the reference's."""
    rng = np.random.default_rng(1)
    grads = [(0.01 * rng.standard_normal(64)).astype(np.float32) for _ in range(50)]
    red, jred = CompressedReducer(), jcomp.CompressedReducer()
    total_c = torch.zeros(64)
    jtotal_c = jnp.zeros(64)
    for g in grads:
        total_c = total_c + red.step({"w": torch.from_numpy(g)})["w"]
        jtotal_c = jtotal_c + jred.step({"w": jnp.asarray(g)})["w"]
    np.testing.assert_allclose(total_c.numpy(), np.asarray(jtotal_c), rtol=0, atol=1e-6)
    total_t = np.sum(grads, axis=0)
    drift = np.abs(total_c.numpy() - total_t).max()
    assert drift < 0.02 * max(np.abs(total_t).max(), 1e-3)


def test_compression_error_is_zero_for_representable():
    g = {"w": torch.tensor([0.0, 127.0, -127.0, 64.0])}
    e = compression_error(g)
    np.testing.assert_allclose(e["w"].numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(
        e["w"].numpy(), np.asarray(jcomp.compression_error({"w": jnp.asarray(g["w"].numpy())})["w"]),
        atol=1e-6)


def test_compressed_all_reduce_across_pods(tmp_path):
    """The twin of the reference's compressed psum on 4 devices: each rank
    quantizes its own row, and ``all_reduce`` over a 4-rank ``"pod"`` axis
    averages the dequantized rows."""
    g = (0.01 * np.random.default_rng(2).standard_normal((4, 128))).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    out = run_with_devices(4, f"""
        import json
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.compat import shard_map
        from repro.optim.compression import quantize

        mesh = jax.make_mesh((4,), ("pod",))
        g = jnp.asarray(np.load({os.fspath(tmp_path / "g.npy")!r}))

        def reduce_compressed(g_local):
            q, s = quantize({{"g": g_local}})
            return jax.lax.psum(q["g"].astype(jnp.float32) * s["g"], "pod") / 4.0

        fn = jax.jit(shard_map(reduce_compressed, mesh=mesh, in_specs=P("pod"),
                               out_specs=P(), check_vma=False))
        with mesh:
            mean_c = fn(g).reshape(-1)
        print("MEAN", json.dumps(np.asarray(mean_c, np.float64).tolist()))
    """)
    want = np.asarray(json.loads(out.split("MEAN", 1)[1]), np.float32)
    ranks = spawn(4, compressed_mean, tmp_path, g)
    for r, res in enumerate(ranks):
        q, s = jcomp.quantize({"g": jnp.asarray(g[r:r + 1])})
        np.testing.assert_array_equal(res["q"].numpy(), np.asarray(q["g"]))
        # int8 error bound: scale/2 per shard ~ max|g|/254 ~ 1.6e-4
        np.testing.assert_allclose(res["mean"].numpy(), want, rtol=0, atol=8e-4)
        np.testing.assert_allclose(res["mean"].numpy(), g.mean(axis=0), rtol=0, atol=8e-4)
        np.testing.assert_array_equal(res["mean"].numpy(), ranks[0]["mean"].numpy())
