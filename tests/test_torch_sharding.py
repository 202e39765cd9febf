"""The port's sharding rules and sharded leaf against the JAX package's.

Twins of ``tests/test_parallel.py``'s sharding tests and
``tests/test_integration_tp.py``'s rules test, then two exact checks: the
port's ``PartitionSpec`` equals the JAX package's for every leaf of "tiny"
and of "1b" under three meshes (the JAX shapes from ``jax.eval_shape``, so
nothing large is allocated), and for "tiny" the port's piece bounds and
data equal the JAX arrays' ``addressable_shards``, bitwise. The JAX side
runs on conftest's 8 CPU devices, the port on ``["cpu"] * n`` virtual
meshes.
"""

import numpy as np
import pytest
import torch

import jax

from torchft_tpu.checkpointing import _normalize_index
from torchft_tpu.models import transformer as jtf
from torchft_tpu.parallel import ft_mesh as jft_mesh
from torchft_tpu.parallel import make_sharding_fn as jmake_sharding_fn
from torchft_tpu.parallel import shard_pytree as jshard_pytree
from torchft_tpu.parallel.sharding import tp_rules_gpt as jtp_rules_gpt
from torchft_tpu_torch.parallel import (
    FTMesh,
    NamedSharding,
    PartitionSpec as P,
    ShardedTensor,
    fsdp_sharding,
    ft_mesh,
    make_sharding_fn,
    shard_pytree,
    tp_rules_gpt,
)
from torchft_tpu_torch.utils.serialization import (
    is_tensor_leaf,
    tree_flatten_with_path,
)

MESHES = [{"fsdp": 2, "tensor": 2}, {"tensor": 4}, {"fsdp": 8}]


def _cpu_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return ft_mesh(axes, devices=["cpu"] * n)


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jft_mesh(axes, devices=jax.devices()[:n])


def _flat_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_paths(v, key))
        else:
            out[key] = v
    return out


# ------------------------------------------------------ the ported tests


def test_fsdp_sharding_largest_dim() -> None:
    mesh = _cpu_mesh({"fsdp": 8})
    s = fsdp_sharding(mesh, (16, 128))
    assert s.spec == P(None, "fsdp")  # 128 is the largest divisible dim
    s = fsdp_sharding(mesh, (64, 6))
    assert s.spec == P("fsdp", None)
    # too small to shard -> replicated
    s = fsdp_sharding(mesh, (3, 5))
    assert s.spec == P(None, None)
    s = fsdp_sharding(mesh, ())
    assert s.spec == P()


def test_tp_plus_fsdp_composition() -> None:
    mesh = _cpu_mesh({"fsdp": 2, "tensor": 4})
    fn = make_sharding_fn(mesh, tp_rules_gpt())
    params = {
        "layers_0/attn/q_proj/kernel": np.zeros((64, 64), np.float32),
        "layers_0/mlp/down_proj/kernel": np.zeros((256, 64), np.float32),
        "ln_f/scale": np.zeros((64,), np.float32),
    }
    specs = {path: fn(path, leaf).spec for path, leaf in params.items()}
    # q_proj column-parallel on tensor, fsdp takes the other dim
    assert specs["layers_0/attn/q_proj/kernel"] == P("fsdp", "tensor")
    # down_proj row-parallel
    assert specs["layers_0/mlp/down_proj/kernel"][0] == "tensor"
    # norm scale: no tensor dim; fsdp may take the (divisible) vector dim
    assert "tensor" not in specs["ln_f/scale"]


def test_shard_pytree_places_arrays() -> None:
    mesh = _cpu_mesh({"fsdp": 8})
    params = {"w": np.ones((32, 16), np.float32),
              "b": np.ones((8,), np.float32)}
    sharded = shard_pytree(params, mesh, fsdp_axis="fsdp", tp_rules=None)
    assert isinstance(sharded["w"], ShardedTensor)
    assert isinstance(sharded["w"].sharding, NamedSharding)
    assert sharded["w"].sharding.spec == P("fsdp", None)
    np.testing.assert_allclose(sharded["w"].full().numpy(),
                               np.ones((32, 16)))
    # one piece per fsdp position, each on its device
    assert len(sharded["w"].pieces) == 8
    assert all(p.shape == (4, 16) and p.device.type == "cpu"
               for p in sharded["w"].pieces)


def test_tp_sharding_rules_applied() -> None:
    # tests/test_integration_tp.py's mini block on a {"tensor": 4} mesh
    d, d_ff = 8, 16

    def full(shape, v):
        return np.full(shape, v, np.float32)

    params = {"layers_0": {
        "attn": {"q_proj": {"kernel": full((d, d), 1.0)},
                 "o_proj": {"kernel": full((d, d), 0.5)}},
        "mlp": {"up_proj": {"kernel": full((d, d_ff), 1 / 3)},
                "down_proj": {"kernel": full((d_ff, d), 0.25)}}}}
    expected = {"q_proj": P(None, "tensor"), "o_proj": P("tensor", None),
                "up_proj": P(None, "tensor"), "down_proj": P("tensor", None)}
    block = shard_pytree(params, _cpu_mesh({"tensor": 4}),
                         tp_rules=tp_rules_gpt(), fsdp_axis=None)["layers_0"]
    for mod, sub in (("attn", "q_proj"), ("attn", "o_proj"),
                     ("mlp", "up_proj"), ("mlp", "down_proj")):
        leaf = block[mod][sub]["kernel"]
        assert leaf.sharding.spec == expected[sub], (sub, leaf.sharding.spec)


# --------------------------------------------------- exact, against JAX


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
@pytest.mark.parametrize("config", ["tiny", "1b"])
def test_specs_equal_the_reference_for_every_leaf(config, axes) -> None:
    jcfg = jtf.CONFIGS[config]
    shapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                            jax.random.key(0))
    jfn = jmake_sharding_fn(_jax_mesh(axes), jtp_rules_gpt())
    fn = make_sharding_fn(_cpu_mesh(axes), tp_rules_gpt())
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(flat) == 5 + 10 * jcfg.n_layers
    for path, leaf in flat:
        want = jfn(path, leaf).spec
        name = "/".join(str(p.key) for p in path)
        got = fn(name, torch.empty(leaf.shape, device="meta")).spec
        # the port's spec is the reference's, entry for entry; the path
        # reaches the rules in either form
        assert tuple(got) == tuple(want), (name, got, want)
        assert fn(path, leaf).spec == got


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_pieces_equal_the_reference_shards_bitwise(axes) -> None:
    jcfg = jtf.CONFIGS["tiny"]
    params = jax.device_get(jtf.init_params(jcfg, jax.random.key(3)))
    jsharded = jshard_pytree(params, _jax_mesh(axes), tp_rules=jtp_rules_gpt())
    sharded = shard_pytree(params, _cpu_mesh(axes), tp_rules=tp_rules_gpt())
    jflat = _flat_paths(jsharded)
    flat = _flat_paths(sharded)
    assert set(flat) == set(jflat)
    for path, jleaf in jflat.items():
        leaf = flat[path]
        shape = tuple(jleaf.shape)
        assert leaf.shape == shape and leaf.dtype == torch.float32
        # per device position: the reference's shard index is the port's
        # bounds at the same position, and the data equal, bitwise
        jbounds = [_normalize_index(sh.index, shape)
                   for sh in jleaf.addressable_shards]
        assert leaf.sharding.position_bounds(shape) == jbounds, path
        for pos, sh in enumerate(jleaf.addressable_shards):
            piece = leaf.piece_at(pos)
            assert piece.numpy().tobytes() == \
                np.asarray(sh.data).tobytes(), (path, pos)
        # the distinct regions are held once on a virtual mesh
        assert sorted(set(leaf.bounds)) == sorted(set(jbounds))
        assert len(leaf.pieces) == len(set(jbounds))
        assert leaf.full().numpy().tobytes() == \
            np.asarray(params_at(params, path)).tobytes()


def params_at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# ------------------------------------------------------ the sharded leaf


def test_sharded_leaf_is_one_leaf_of_the_heal_plane() -> None:
    mesh = _cpu_mesh({"fsdp": 2, "tensor": 2})
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    leaf = ShardedTensor.from_full(w, NamedSharding(mesh, P("fsdp",
                                                            "tensor")))
    flat, _ = tree_flatten_with_path({"a": {"w": leaf}, "step": 3})
    assert [p for p, _ in flat] == ["['a']['w']", "['step']"]
    assert flat[0][1] is leaf and is_tensor_leaf(leaf)
    assert leaf.nbytes == w.nbytes
    # bounds in the mesh's row-major order, as the reference's shards
    assert leaf.bounds == [((0, 4), (0, 4)), ((0, 4), (4, 8)),
                           ((4, 8), (0, 4)), ((4, 8), (4, 8))]
    assert torch.equal(leaf.full(), torch.from_numpy(w))


def test_replicated_regions_are_held_once_per_device() -> None:
    # a virtual mesh holds a region replicated over tensor once; a mesh of
    # distinct devices holds it once per device (the addressable shards)
    from torchft_tpu_torch.parallel.mesh import Mesh

    w = np.arange(8, dtype=np.float32)
    virtual = _cpu_mesh({"fsdp": 2, "tensor": 2})
    leaf = ShardedTensor.from_full(w, NamedSharding(virtual, P("fsdp")))
    assert leaf.bounds == [((0, 4),), ((4, 8),)]
    assert [leaf._index[p] for p in range(4)] == [0, 0, 1, 1]
    grid = np.empty(4, dtype=object)
    grid[:] = [torch.device("cpu"), torch.device("meta")] * 2
    mixed = Mesh(grid.reshape(2, 2), ("fsdp", "tensor"))
    assert len(NamedSharding(mixed, P("fsdp")).position_bounds((8,))) == 4
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(virtual, P("fsdp")).position_bounds((7,))
    with pytest.raises(ValueError, match="not in the mesh"):
        NamedSharding(virtual, P("expert"))


def test_ftmesh_sharding() -> None:
    from unittest.mock import MagicMock

    mesh = _cpu_mesh({"fsdp": 2, "tensor": 2})
    ftm = FTMesh(MagicMock(), mesh)
    s = ftm.sharding("fsdp", None)
    assert s == NamedSharding(mesh, P("fsdp", None))
    assert s.spec == P("fsdp", None) and s.spec[0] == "fsdp"
    assert s != NamedSharding(mesh, P(None, "fsdp"))
    view = ftm["replica"]
    with pytest.raises(ValueError, match="no in-group mesh"):
        view.sharding("fsdp")
