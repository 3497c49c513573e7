"""PyTorch port, partition rules (``models/partitioning.py``,
``models/sharding.py``) against the JAX package's: for every architecture of
the registry, the parameter specs (with and without FSDP), the batch specs
of every shape and the decode caches' specs equal the JAX
``PartitionSpec``s leaf by leaf on ``AbstractMesh`` shapes (16, 16),
(2, 16, 16), (32, 8) and (2, 32, 8), the JAX side built as
``tests/test_partitioning.py`` builds it. Also the production mesh, the
rules' axis dropping and ``per_device_bytes``."""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as PS

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import common as J_common
from repro.configs import get_arch as j_get_arch
from repro.models import partitioning as J_part
from repro.models import sharding as J_sharding
from repro_torch.configs import common as T_common
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import partitioning as T_part
from repro_torch.models import sharding as T_sharding
from repro_torch.models.params import tree_leaves

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model")), ((2, 32, 8), ("pod", "data", "model"))]


def _abstract(shape, names):
    try:
        return AbstractMesh(shape, names)
    except TypeError:  # jax 0.4.x: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(zip(names, shape)))


def _jax_leaves(tree, specs):
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, PS))
    assert len(leaves) == len(specs)
    return [tuple(s) + (None,) * (len(x.shape) - len(s)) for x, s in zip(leaves, specs)]


def _sorted_leaves(tree) -> list:
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _port_leaves(tree, specs):
    leaves, out = _sorted_leaves(tree), _sorted_leaves(specs)
    assert len(leaves) == len(out) and all(len(s) == x.dim() for x, s in zip(leaves, out))
    return out


@pytest.mark.parametrize("aid", J_ARCH_IDS)
def test_specs_equal_jax_leaf_by_leaf_on_every_mesh(aid):
    cfg, jcfg = get_arch(aid).config(), j_get_arch(aid).config()
    tparams, jparams = T_common.params_specs(cfg), J_common.params_specs(jcfg)
    decode = {n: (T_common.decode_specs(cfg, s), J_common.decode_specs(jcfg, J_common.SHAPES[n]))
              for n, s in T_common.SHAPES.items() if s.kind == "decode"}
    for shape, names in MESHES:
        jmesh = _abstract(shape, names)
        tmesh = dict(zip(names, shape))
        for fsdp in (True, False):
            got = _port_leaves(tparams, T_part.param_pspecs(cfg, tparams, tmesh, fsdp=fsdp))
            want = _jax_leaves(jparams, J_part.param_pspecs(jcfg, jparams, jmesh, fsdp=fsdp))
            assert got == want, (aid, shape, fsdp)
        for name, s in T_common.SHAPES.items():
            tb, jb = T_common.lm_batch_specs(cfg, s), J_common.lm_batch_specs(jcfg, J_common.SHAPES[name])
            assert (_port_leaves(tb, T_part.batch_pspecs(cfg, tb, tmesh))
                    == _jax_leaves(jb, J_part.batch_pspecs(jcfg, jb, jmesh))), (aid, shape, name)
        for name, (tspec, jspec) in decode.items():
            got = _port_leaves(tspec["cache"], T_part.cache_pspecs(cfg, tspec["cache"], tmesh))
            want = _jax_leaves(jspec["cache"], J_part.cache_pspecs(jcfg, jspec["cache"], jmesh))
            assert got == want, (aid, shape, name)


def test_production_mesh_and_rules():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 32, "model": 8} and one.size == 256
    assert two.shape == {"pod": 2, "data": 32, "model": 8} and two.size == 512
    assert T_sharding.DEFAULT_RULES == J_sharding.DEFAULT_RULES
    jmesh = _abstract((16, 16), ("data", "model"))
    names = ("batch", "seq", "heads", "vocab", None, "fsdp")
    with J_sharding.use_mesh_rules(jmesh):
        want = tuple(J_sharding.spec_for(*names))
    assert T_sharding.spec_for({"data": 16, "model": 16}, *names) == want


def test_per_device_bytes_is_exact():
    cfg = get_arch("qwen3_0_6b").config()
    params = T_common.params_specs(cfg)
    mesh = make_production_mesh()
    specs = T_part.param_pspecs(cfg, params, mesh)
    total = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    per = T_part.per_device_bytes(params, specs, mesh)
    want = 0
    for x, s in zip(_sorted_leaves(params), _port_leaves(params, specs)):
        n = int(np.prod([mesh.shape[a] for e in s if e for a in (e if isinstance(e, tuple) else (e,))]))
        assert x.numel() % n == 0
        want += x.numel() * x.element_size() // n
    assert per == want and total / 256 <= per < total
