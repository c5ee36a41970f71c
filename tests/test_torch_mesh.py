"""The port's mesh (`parallel/mesh.py`) and `sharded_topk` on gloo ranks,
against the JAX package's mesh on its 8 CPU devices and its single-device
oracle (`tests/test_mesh.py`'s cases at 2 and 4 ranks, 1e-5).

Each world of ranks is spawned once for the module (`tests/torch_ranks.py`);
every case reads the numpy results it returned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.parallel import MeshSpec as JMeshSpec
from rag_dpo_tpu.parallel import create_mesh as j_create_mesh
from rag_dpo_tpu.parallel import shard_leading_axis as j_shard_leading_axis
from rag_dpo_tpu.parallel import sharded_topk as j_sharded_topk
from rag_dpo_tpu_torch.parallel import MeshSpec, create_mesh
from rag_dpo_tpu_torch.parallel.mesh import pad_to_multiple
from torch_ranks import run_ranks

WORLDS = (2, 4)


def _corpus(n, d, q, seed, normed=True):
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((n, d), dtype=np.float32)
    qs = rng.standard_normal((q, d), dtype=np.float32)
    if normed:
        embs /= np.linalg.norm(embs, axis=1, keepdims=True)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return embs, qs


def _rank_cases(rank, world):
    from rag_dpo_tpu_torch.parallel import (
        host_local_rows,
        replicated,
        shard_leading_axis,
        sharded_topk,
    )
    from rag_dpo_tpu_torch.parallel.mesh import axis_index, axis_size

    out = {}
    spec = MeshSpec.for_devices(world, model=2 if world == 4 else 1)
    mesh = create_mesh(spec, device_type="cpu")
    out["shape"] = tuple(axis_size(mesh, a) for a in
                         ("data", "model", "shard"))
    out["coords"] = tuple(axis_index(mesh, a) for a in
                          ("data", "model", "shard"))
    mesh = create_mesh(MeshSpec(shard=world), device_type="cpu")
    x = np.arange(8 * world * 3).reshape(8 * world, 3)
    out["rows"] = shard_leading_axis(mesh, x).numpy()
    out["repl"] = replicated(mesh, x).numpy()
    out["host_local"] = host_local_rows(
        x.shape, mesh, x[rank * 8:(rank + 1) * 8]).numpy()
    try:
        host_local_rows(x.shape, mesh, x[:3])
    except ValueError as e:
        out["host_local_error"] = str(e)
    for name, (n, d, q, k) in (("dense", (512, 64, 4, 10)),
                               ("small", (32, 16, 2, 8))):
        embs, qs = _corpus(n, d, q, 0 if name == "dense" else 1,
                           normed=name == "dense")
        search = sharded_topk(mesh, lambda a, b: a @ b.T, k)
        s, i = search(torch.from_numpy(qs),
                      shard_leading_axis(mesh, embs),
                      shard_leading_axis(mesh, np.arange(n, dtype=np.int32)))
        out[name] = (s.numpy(), i.numpy())
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request):
    return request.param, run_ranks(_rank_cases, request.param)


def test_mesh_spec_devices():
    for n, model in ((8, 1), (8, 2), (4, 4), (6, 3)):
        assert MeshSpec.for_devices(n, model=model) == \
            MeshSpec(**vars(JMeshSpec.for_devices(n, model=model)))
    with pytest.raises(ValueError, match="divisible"):
        MeshSpec.for_devices(6, model=4)
    assert MeshSpec(2, 2, 2).n_devices == 8
    assert pad_to_multiple(10, 4) == 12 and pad_to_multiple(12, 4) == 12


def test_create_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_mesh(MeshSpec())
    with pytest.raises(ValueError, match="device_type"):
        create_mesh(MeshSpec(), device_type="tpu")


def test_create_mesh_axes_and_coordinates(ranks):
    world, res = ranks
    spec = MeshSpec.for_devices(world, model=2 if world == 4 else 1)
    grid = np.arange(world).reshape(spec.data, spec.model, spec.shard)
    for r, out in enumerate(res):
        assert out["shape"] == (spec.data, spec.model, spec.shard)
        assert out["coords"] == tuple(int(c[0]) for c in
                                      np.nonzero(grid == r))


def test_rank_slices_match_jax_sharding(ranks, eight_devices):
    world, res = ranks
    x = np.arange(8 * world * 3).reshape(8 * world, 3)
    jmesh = j_create_mesh(JMeshSpec(shard=world),
                          devices=jax.devices()[:world])
    jx = jax.device_put(jnp.asarray(x), j_shard_leading_axis(jmesh))
    want = {int(s.device.id): np.asarray(s.data)
            for s in jx.addressable_shards}
    order = [d.id for d in jmesh.devices.flat]
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["rows"], want[order[r]])
        np.testing.assert_array_equal(out["repl"], x)
        np.testing.assert_array_equal(out["host_local"], out["rows"])
        assert "expected" in out["host_local_error"]


def test_sharded_topk_matches_dense_and_jax_mesh(ranks, eight_devices):
    world, res = ranks
    embs, qs = _corpus(512, 64, 4, 0)
    ref = qs @ embs.T
    ref_ids = np.argsort(-ref, axis=1, kind="stable")[:, :10]
    ref_s = np.take_along_axis(ref, ref_ids, axis=1)
    jmesh = j_create_mesh(JMeshSpec(shard=8))
    sh = j_shard_leading_axis(jmesh)
    js, ji = j_sharded_topk(jmesh, lambda a, b: a @ b.T, 10)(
        jnp.asarray(qs), jax.device_put(jnp.asarray(embs), sh),
        jax.device_put(jnp.arange(512, dtype=jnp.int32), sh))
    for out in res:
        s, i = out["dense"]
        np.testing.assert_allclose(s, ref_s, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s, np.asarray(js), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_array_equal(i, ref_ids)
        np.testing.assert_array_equal(i, res[0]["dense"][1])


def test_sharded_topk_k_larger_than_shard(ranks):
    world, res = ranks
    embs, qs = _corpus(32, 16, 2, 1, normed=False)
    ref_top = np.sort(qs @ embs.T, axis=1)[:, ::-1][:, :8]
    for out in res:
        np.testing.assert_allclose(out["small"][0], ref_top, rtol=1e-5,
                                   atol=1e-5)
