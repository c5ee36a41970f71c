"""`tests/test_multihost.py`'s cases on the port: two processes joined by
`initialize_multihost` over gloo (the CPU stand-in for two hosts, one
device each), the shard axis spanning both.

* a planted nearest neighbour on the other process comes back at rank 1
  through the merge, each process having loaded only its own rows
  (`host_local_rows`);
* the production `DeviceIndex` (dense, masked, ELL, postings, int8 and RRF
  over the arms) equals the single-device oracle, with planted winners on
  the other process;
* the guards of `create_multihost_mesh` and an idempotent init;
* decoder TP with the model axis spanning both processes: greedy tokens
  (f32 and int8 KV caches) equal the unsharded run;
* the sharded train step with the data axis spanning both processes, each
  feeding only its own rows (`host_local_rows`): the one-process step's
  losses and parameters on the whole batch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rag_dpo_tpu_torch.parallel import initialize_multihost
from torch_ranks import run_ranks

N, D, ELL = 64, 16, 4


def _data():
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((N, D)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    terms = rng.integers(0, 40, size=(N, ELL)).astype(np.int32)
    impacts = np.abs(rng.standard_normal((N, ELL))).astype(np.float32)
    terms[51, 0] = 77                 # planted lexical winner (process 1)
    impacts[51, 0] = 9.0
    return dense, terms, impacts


def _check(tag, got, want, atol=2e-2):
    (gs, gi), (ws, wi) = got, want
    valid = wi >= 0
    assert (gi[valid] == wi[valid]).all(), (tag, gi, wi)
    assert np.allclose(gs[valid], ws[valid], atol=atol), tag
    assert ((gi < 0) == (wi < 0)).all(), tag


def _planted(rank, world):
    from rag_dpo_tpu_torch.parallel import (
        MeshSpec,
        create_multihost_mesh,
        host_local_rows,
        is_multihost,
        sharded_topk,
    )

    assert is_multihost()
    # one device a host: the shard axis must span the hosts
    mesh = create_multihost_mesh(MeshSpec(data=1, model=1, shard=2),
                                 allow_split_collectives=True,
                                 device_type="cpu")
    dense, _, _ = _data()
    mine = dense[rank * 32:(rank + 1) * 32]       # no process holds all
    rows = host_local_rows((N, D), mesh, mine)
    ids = host_local_rows((N,), mesh, np.arange(rank * 32, (rank + 1) * 32,
                                                dtype=np.int32))
    s, i = sharded_topk(mesh, lambda q, e: q @ e.T, 3)(
        torch.from_numpy(dense[[40]]), rows, ids)
    return int(i[0, 0])


def _production_index(rank, world):
    from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig
    from rag_dpo_tpu_torch.ops.fusion import rrf_fuse
    from rag_dpo_tpu_torch.parallel import MeshSpec, create_multihost_mesh

    mesh = create_multihost_mesh(MeshSpec(shard=2),
                                 allow_split_collectives=True,
                                 device_type="cpu")
    dense, terms, impacts = _data()
    metas = [{"nature": ["DOCTRINE", "GUIDE", "SANCTION"][i % 3]}
             for i in range(N)]

    def build(mesh=None, **cfg):
        idx = DeviceIndex(IndexConfig(dim=D, ell_width=ELL, row_block=8,
                                      **cfg),
                          device="cpu" if mesh is None else None, mesh=mesh)
        idx.add([f"chunk_{i}" for i in range(N)], dense, metas, terms,
                impacts)
        return idx

    q = dense[[40, 10]]          # row 40 lives on process 1, 10 on 0
    sh, si = build(mesh), build()
    got = sh.search_dense(q, 8)
    _check("dense", got, si.search_dense(q, 8, exact=True))
    assert got[1][0, 0] == 40 and got[1][1, 0] == 10
    where = {"nature": "GUIDE"}
    gm = sh.search_dense(q, 8, where=where)
    _check("masked", gm, si.search_dense(q, 8, where=where, exact=True))
    assert gm[1][0, 0] == 40
    qt = np.array([[77, 3, -2, -2]], np.int32)
    qw = np.array([[2.0, 0.5, 0.0, 0.0]], np.float32)
    gs = sh.search_sparse(qt, qw, 5)
    _check("sparse_ell", gs, si.search_sparse(qt, qw, 5), atol=1e-4)
    assert gs[1][0, 0] == 51
    gp = build(mesh, postings_threshold=4).search_sparse(qt, qw, 5)
    _check("sparse_postings", gp, si.search_sparse(qt, qw, 5), atol=1e-4)
    for cfg in ({}, {"device_refine": True}):
        gi8 = build(mesh, quantize_int8=True, **cfg).search_dense(
            dense[[55, 7]], 8)
        _check("int8", gi8, build(quantize_int8=True, **cfg).search_dense(
            dense[[55, 7]], 8), atol=1e-3)
        assert gi8[1][0, 0] == 55 and gi8[1][1, 0] == 7
    w = torch.tensor([2.0, 1.5])

    def fused(d_rows, s_rows):
        return rrf_fuse(torch.from_numpy(np.stack([d_rows, s_rows])), w,
                        k_rrf=60, topk=5)[1].numpy()

    a = fused(sh.search_dense(q[:1], 10)[1], sh.search_sparse(qt, qw, 10)[1])
    b = fused(si.search_dense(q[:1], 10, exact=True)[1],
              si.search_sparse(qt, qw, 10)[1])
    return a, b


def _guards(rank, world):
    from rag_dpo_tpu_torch.parallel import MeshSpec, create_multihost_mesh

    mesh = create_multihost_mesh(device_type="cpu")
    shape = tuple(mesh.size(i) for i in range(3))
    initialize_multihost("127.0.0.1:1", 2, rank)   # initialized: a no-op
    initialize_multihost()
    errors = []
    for spec in (MeshSpec(data=64, model=1, shard=64), MeshSpec(shard=2)):
        try:
            create_multihost_mesh(spec, device_type="cpu")
        except ValueError as e:
            errors.append(str(e))
    return shape, errors


def _decoder_tp(rank, world, params):
    from rag_dpo_tpu_torch.models.decoder import DecoderConfig
    from rag_dpo_tpu_torch.models.generate import SamplingConfig
    from rag_dpo_tpu_torch.models.generate import TextGenerator
    from rag_dpo_tpu_torch.models.sharding import shard_params
    from rag_dpo_tpu_torch.parallel import MeshSpec, create_multihost_mesh

    cfg = DecoderConfig.tiny(num_heads=4, num_kv_heads=2,
                             dtype=torch.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 512, (2, 10)).astype(np.int32)
    lengths = np.asarray([10, 7], np.int32)
    sampling = SamplingConfig(temperature=0.0, max_new_tokens=4, eos_id=-1)
    mesh = create_multihost_mesh(MeshSpec(data=1, model=2, shard=1),
                                 allow_split_collectives=True,
                                 device_type="cpu")
    out = []
    for c in (cfg, dataclasses.replace(cfg, quantize_kv=True)):
        ref = TextGenerator(c, params=params, device="cpu").generate_ids(
            ids, lengths, sampling)
        tp = TextGenerator(c, params=shard_params(params, mesh),
                           device="cpu").generate_ids(ids, lengths, sampling)
        out.append((np.asarray(ref), np.asarray(tp)))
    return out


def _train_two_hosts(rank, world, seed):
    from rag_dpo_tpu_torch.models.bge_m3 import full_flax_tree
    from rag_dpo_tpu_torch.models.convert import flax_to_state_dict
    from rag_dpo_tpu_torch.parallel import (
        MeshSpec,
        create_multihost_mesh,
        host_local_rows,
    )
    from rag_dpo_tpu_torch.parallel.mesh import AXIS_DATA
    from rag_dpo_tpu_torch.train import (
        create_train_state,
        make_sharded_train_step,
    )
    from torch_train_ranks import make_batch, port_config, to_torch

    cfg = port_config("data2")
    mesh = create_multihost_mesh(MeshSpec(data=2), device_type="cpu")
    step, state = make_sharded_train_step(
        cfg, mesh, create_train_state(cfg, rng_seed=seed, device="cpu"))
    whole = to_torch(make_batch(seed, True))
    mine = {k: host_local_rows(v.shape, mesh, v[2 * rank:2 * rank + 2],
                               AXIS_DATA)    # no process holds the rest
            for k, v in whole.items()}
    losses = []
    for _ in range(3):
        state, metrics = step(state, mine, local=True)
        losses.append(float(metrics["loss"]))
    return losses, flax_to_state_dict(full_flax_tree(state.model))


def test_two_process_planted_neighbour_crosses_processes():
    assert run_ranks(_planted, 2) == [40, 40]


def test_two_process_production_index():
    for fused, oracle in run_ranks(_production_index, 2):
        np.testing.assert_array_equal(fused, oracle)


def test_create_multihost_mesh_guards_and_idempotent_init():
    initialize_multihost()            # no address, no launcher: a no-op
    import torch.distributed as dist

    assert not dist.is_initialized()
    for shape, errors in run_ranks(_guards, 2):
        assert shape == (2, 1, 1)     # default: data = hosts (one rank each)
        assert len(errors) == 2
        assert "covers" in errors[0] and "cross hosts" in errors[1]


def test_two_process_decoder_tp():
    """The JAX module's key(0) init, as each JAX process makes it."""
    import jax.numpy as jnp

    from rag_dpo_tpu.models.decoder import DecoderConfig
    from test_torch_decoder import jax_params

    params = jax_params(DecoderConfig.tiny(num_heads=4, num_kv_heads=2,
                                           dtype=jnp.float32))
    for per_cache in run_ranks(_decoder_tp, 2, params):
        for ref, tp in per_cache:
            np.testing.assert_array_equal(ref, tp)


def test_two_process_train_step_feeds_host_local_rows():
    """Each process loads only its half of the batch; three steps equal
    the one-process step on the whole batch: losses within 1e-6, the
    parameters by `test_torch_train.py`'s rule (1% of Σ lr; the key bias,
    whose gradient is 0 in exact arithmetic, Σ lr): only the order of the
    sums differs."""
    from rag_dpo_tpu_torch.models.bge_m3 import full_flax_tree
    from rag_dpo_tpu_torch.models.convert import flax_to_state_dict
    from rag_dpo_tpu_torch.train import create_train_state, make_train_step
    from rag_dpo_tpu_torch.train.contrastive import learning_rate_at
    from torch_train_ranks import make_batch, port_config, to_torch

    cfg = port_config("data2")
    state = create_train_state(cfg, rng_seed=5, device="cpu")
    step = make_train_step(cfg, state)
    want = []
    for _ in range(3):
        state, metrics = step(state, to_torch(make_batch(5, True)))
        want.append(float(metrics["loss"]))
    params = flax_to_state_dict(full_flax_tree(state.model))
    lr_sum = sum(learning_rate_at(cfg, c) for c in range(3))
    for losses, got in run_ranks(_train_two_hosts, 2, 5):
        np.testing.assert_allclose(losses, want, rtol=1e-6)
        for name, value in got.items():
            atol = lr_sum if name.endswith("key.bias") else 0.01 * lr_sum
            np.testing.assert_allclose(value, params[name], atol=atol,
                                       rtol=1e-5, err_msg=name)
