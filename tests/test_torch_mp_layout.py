"""The port's tensor-parallel layout (``unimm_torch/parallel/mesh.py``)
against the JAX package's (``unimm_tpu/parallel/mesh.py``), on the default
config's shapes (``config/bert_base_6layer_6conect.json``, 534 tensors,
250,090,109 parameters), with nothing large computed: JAX's tree through
``jax.eval_shape``, the port's model on the meta device.

- ``param_spec`` is JAX's on every parameter path;
- at mp 2, 3 and 4 each parameter's sharded torch dim, or none, is JAX's
  ``param_shardings`` on ``make_mesh(2 * mp, mp=mp)`` transposed (a JAX
  kernel is [in, out], a torch weight [out, in]; the embedding table is
  not transposed): 193, 85 and 192 tensors, the divisibility fallback
  included (at mp 3 every 1024- or 4096-wide sharded dim stays whole, at
  mp 4 the 30522-row word embeddings);
- the parameters a rank holds drop as the layout says, and with them its
  fp32 training state (master, gradient and two moments, 16 bytes a
  parameter): 4.001 GB at mp 1, 2.065 at mp 2, 1.378 at mp 4;
- the grid: rank r is dp index r // mp and mp index r % mp;
- ``-mesh_mp`` is refused only where it names no world: without
  ``-coordinator_address``, or not dividing the world's size.
"""

import os

import jax
import pytest
import torch
from jax.sharding import PartitionSpec

from unimm_torch import checkpoint as C
from unimm_torch.cli import options
from unimm_torch.config import VilbertConfig
from unimm_torch.models import vilbert
from unimm_torch.parallel import dist, mesh
from unimm_tpu.config import VilbertConfig as JConfig
from unimm_tpu.models import vilbert as jv
from unimm_tpu.parallel import mesh as pmesh

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config", "bert_base_6layer_6conect.json")
SHARDED = {2: 193, 3: 85, 4: 192}
# parameters a rank holds, and its fp32 training state in GB
A_RANK = {1: (250090109, 4.001), 2: (129055613, 2.065), 4: (86119037, 1.378)}


@pytest.fixture(scope="module")
def jax_tree():
    cfg = JConfig.from_json_file(CONFIG)
    return jax.eval_shape(lambda key: jv.init_params(key, cfg),
                          jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def meta_model():
    with torch.device("meta"):
        return vilbert.VilbertModel(VilbertConfig.from_json_file(CONFIG))


def test_paths_and_specs_are_jax_s(jax_tree, meta_model):
    paths = mesh.jax_paths(meta_model)
    items = C.iter_param_items(jax_tree)
    assert len(items) == len(paths) == 534
    assert {C.torch_name(p) for p, _ in items} == set(paths)
    for name, path in paths.items():
        assert C.torch_name(path) == name
        assert mesh.param_spec(path) == tuple(pmesh.param_spec(path)), name
    assert sum(p.numel() for p in meta_model.parameters()) == 250090109


@pytest.mark.parametrize("mp", sorted(SHARDED))
def test_layout_matches_param_shardings(jax_tree, meta_model, mp):
    shardings = pmesh.param_shardings(jax_tree,
                                      pmesh.make_mesh(2 * mp, mp=mp))
    want = {}
    for path, s in C.iter_param_items(shardings):
        spec = tuple(s.spec)
        if pmesh.MP in spec:
            i = spec.index(pmesh.MP)
            want[C.torch_name(path)] = 1 - i if path[-1] == "kernel" else i
        else:
            assert s.spec == PartitionSpec()
    got = mesh.layout_dims(meta_model, mp)
    assert got == want
    assert len(got) == SHARDED[mp]
    shapes = dict(meta_model.named_parameters())
    for name, d in got.items():
        assert shapes[name].shape[d] % mp == 0


@pytest.mark.parametrize("mp", sorted(A_RANK))
def test_state_bytes_a_rank(meta_model, mp):
    dims = mesh.layout_dims(meta_model, mp)
    n = sum(p.numel() // mp if name in dims else p.numel()
            for name, p in meta_model.named_parameters())
    assert (n, round(16 * n / 1e9, 3)) == A_RANK[mp]


def test_grid_groups():
    dp, mp = dist.grid_groups(4, 2)
    assert dp == [[0, 2], [1, 3]] and mp == [[0, 1], [2, 3]]
    assert dist.grid_groups(4, 1) == ([[0, 1, 2, 3]], [[0], [1], [2], [3]])
    assert dist.grid_groups(2, 2) == ([[0], [1]], [[0, 1]])
    with pytest.raises(ValueError, match="does not divide"):
        dist.grid_groups(4, 3)


WORLD4 = ["-coordinator_address", "127.0.0.1:1", "-num_processes", "4",
          "-process_id", "0"]


@pytest.mark.parametrize("argv,match", [
    (["-mesh_mp", "3"] + WORLD4, "-mesh_mp 3 does not divide the world's 4"),
    (["-mesh_mp", "2"], "-mesh_mp 2 without a world"),
])
def test_mesh_mp_refusals(argv, match):
    with pytest.raises(ValueError, match=match):
        options.read_command_line(argv + ["-save_name", "x"])


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_mesh_mp_admitted_in_a_world(mp):
    params = options.read_command_line(["-mesh_mp", str(mp)] + WORLD4
                                       + ["-save_name", "x"])
    assert params["mesh_mp"] == mp
