"""Port parity: tensor parallelism over a (data, model) mesh
(kmsr_tpu_torch.parallel.gan_sharding vs kmsr_tpu.parallel.gan_sharding),
on the CPU.

- The per-leaf specs equal JAX's `state_shardings` on a ("data", "model")
  mesh of the forced CPU devices, leaf by leaf, for the tiny config of
  `tests/test_train_single.py` (Adam's moments follow their parameters).
- One gloo world of 4 ranks, started once for the module
  (`tests/helpers/dist_world.py`), runs one step on a (2, 2) and a (1, 4)
  mesh in chain mode and one on a (2, 2) mesh in compose mode, from the
  JAX init on the same batch (native-LR real patches: the step makes no
  random draw). Each is held against JAX's single-device `make_train_step`
  at JAX's own TP tolerances (`tests/test_train_single.py:176-190`):
  losses rel 1e-4, G rtol 1e-4 / atol 1e-6, D rtol 1e-2 / atol 5e-4 (D's
  spectral norm contracts over the sharded O axis, and Adam's first step
  turns rounding-level gradients into +-lr), and against the port's
  one-process step at the same tolerances.
- A (1, 1) mesh over a gloo group of one (every model collective runs and
  is the identity) gives the plain step bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from kmsr_tpu.parallel import gan_sharding as jgs
from kmsr_tpu.parallel import make_mesh as jmake_mesh
from kmsr_tpu.train import single_kernel as jsk
from kmsr_tpu_torch import convert
from kmsr_tpu_torch.parallel import gan_sharding as tgs
from kmsr_tpu_torch.parallel import mesh as tmesh
from kmsr_tpu_torch.train import single_kernel as tsk
from kmsr_tpu_torch.train.state import tree_leaves
from tests.helpers import tp_jobs
from tests.helpers.dist_world import run_world

CASES = [((2, 2), "chain"), ((1, 4), "chain"), ((2, 2), "compose")]
LOSS_REL = 1e-4
G_TOL = dict(rtol=1e-4, atol=1e-6)
D_TOL = dict(rtol=1e-2, atol=5e-4)


def _jax_cfg(mode: str):
    from kmsr_tpu.models import DiscriminatorConfig, GeneratorConfig

    return jsk.SingleKernelConfig(
        iters=1, hr_patch_size=64, lr_crop_size=8, batch_size=8, log_every=2,
        kernel_log_every=2, verbose=False, real_is_lr=True,
        generator=GeneratorConfig(mid_ch=8, forward_mode=mode),
        discriminator=DiscriminatorConfig(base_ch=8, num_blocks=2))


def _port_tree(tree):
    return tp_jobs.numpy_tree(convert._tree_to(jax.device_get(tree), torch.device("cpu")))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The batch, the JAX init in the port's layout, and per mode JAX's
    single-device step and the port's one-process step from it."""
    rng = np.random.default_rng(3)
    hr = rng.normal(5, 1, (8, 5, 64, 64)).astype(np.float32)
    lr = rng.normal(5, 2, (8, 5, 8, 8)).astype(np.float32)
    state_j = jsk.init_training(_jax_cfg("chain"))
    init = {"g": _port_tree(state_j.g_params), "d": _port_tree(state_j.d_params),
            "ds": _port_tree(state_j.d_state)}
    out = {"hr": hr, "lr": lr, "init": init, "state_j": state_j}
    for mode in ("chain", "compose"):
        new_j, m_j = jax.jit(jsk.make_train_step(_jax_cfg(mode)))(
            state_j, jnp.asarray(hr), jnp.asarray(lr))
        cfg = tp_jobs.config(mode)
        new_t, m_t = tsk.make_train_step(cfg)(tp_jobs.initial_state(cfg, init),
                                              torch.from_numpy(hr), torch.from_numpy(lr))
        out[mode] = {
            "jax": {"g": _port_tree(new_j.g_params), "d": _port_tree(new_j.d_params),
                    "metrics": {k: float(m_j[k]) for k in tp_jobs.METRICS},
                    "kernels": np.asarray(m_j["kernels"])},
            "port": tp_jobs.step_result(new_t, m_t)}
    return out


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return run_world(tp_jobs.tp_world, 4, tmp, ref["init"], ref["hr"], ref["lr"], CASES)


# ------------------------------------------------------------------- specs
def _by_path(tree, path=""):
    """{JAX keystr: leaf} of a nested dict / list."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items() for p, v in _by_path(t, f"{path}[{k!r}]").items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree) for p, v in _by_path(t, f"{path}[{i}]").items()}
    return {path: tree}


def _jax_specs(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(s.spec)
            for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 2), (1, 8), (8,)])
def test_state_specs_match_jax(ref, shape):
    """Every leaf's spec equals JAX's on a mesh of the forced CPU devices:
    parameters, D state and both Adam moments (keyed by their parameter's
    path), the step and the counts replicated."""
    names = ("data", "model")[:len(shape)]
    jmesh = jmake_mesh(shape, names, jax.devices()[:int(np.prod(shape))])
    want = jgs.state_shardings(jmesh, ref["state_j"])
    mesh = tmesh.Mesh("data", shape[0], 0, torch.device("cpu"), None,
                      *(("model", shape[1], 0, None) if len(shape) == 2 else ()))
    assert mesh.axis_names == names and mesh.shape == dict(zip(names, shape))
    state = tp_jobs.initial_state(tp_jobs.config("chain"), ref["init"])
    got = tgs.state_shardings(mesh, state)
    n = 0
    for field in ("g_params", "d_params", "d_state"):
        g, w = _by_path(getattr(got, field)), _jax_specs(getattr(want, field))
        assert g == w, field
        n += len(g)
    for params, opt in (("g_params", "g_opt_state"), ("d_params", "d_opt_state")):
        paths = list(_by_path(getattr(state, params)))
        jopt = _jax_specs(getattr(want, opt))
        for moment in ("mu", "nu"):
            jm = {p.split(f".{moment}", 1)[1]: s for p, s in jopt.items() if f".{moment}[" in p}
            assert dict(zip(paths, getattr(got, opt)[moment])) == jm, (opt, moment)
        assert getattr(got, opt)["count"] == ()
    assert got.step == () and got.rng == () and n == 26  # 6 G layers, 12 D params, 8 D state
    if len(shape) == 2:
        g_specs = list(_by_path(got.g_params).values())
        assert (None, "model") in g_specs and (None, None, "model") in g_specs
        assert ("model",) in _by_path(got.d_params).values()
    else:
        assert set(_by_path(got.g_params).values()) == {()}


def test_shard_state_keeps_each_ranks_slice(ref):
    """Rank (i, j) of a (2, 4) mesh holds slice j of every sharded leaf
    (tagged with its spec) and a copy of every replicated one."""
    state = tp_jobs.initial_state(tp_jobs.config("chain"), ref["init"])
    mesh = tmesh.Mesh("data", 2, 1, torch.device("cpu"), None, "model", 4, 3, None)
    local = tgs.shard_state(mesh, state)
    w0, wl = state.g_params["layers"][0], local.g_params["layers"][0]
    assert tgs.sharded_axis(wl) == 1 and torch.equal(wl, w0[:, 6:8])
    last = local.g_params["layers"][-1]
    assert tgs.sharded_axis(last) == 2 and torch.equal(last, state.g_params["layers"][-1][:, :, 6:8])
    assert torch.equal(local.d_state["u"][1], state.d_state["u"][1][6:8])
    d_last = local.d_params["convs"][-1]["w"]
    assert tgs.sharded_axis(d_last) is None and torch.equal(d_last, state.d_params["convs"][-1]["w"])
    assert d_last is not state.d_params["convs"][-1]["w"] and d_last.requires_grad
    assert local.g_opt_state["mu"][0].shape == wl.shape and local.step == state.step


# ----------------------------------------------------------------- meshes
def test_two_d_mesh_over_four_ranks(world):
    """Rank r sits at (r // m, r % m) of each mesh, JAX's device order."""
    for sizes, mode in CASES:
        for r, res in enumerate(world):
            assert res[sizes, mode]["coords"] == divmod(r, sizes[1])
            assert res[sizes, mode]["shape"] == {"data": sizes[0], "model": sizes[1]}


def _assemble(world, key, which):
    """The full tree from the ranks' shards (data index 0, model index in
    order); every data replica holds the same shards."""
    ranks = [res[key] for res in world]
    m = ranks[0]["shape"]["model"]
    rows = {}
    for res in ranks:
        rows.setdefault(res["coords"][0], [None] * m)[res["coords"][1]] = res
    for i, row in rows.items():
        for a, b in zip(row, rows[0]):
            for x, y in zip(tree_leaves(tp_jobs.tensor_tree(a[which])),
                            tree_leaves(tp_jobs.tensor_tree(b[which]))):
                assert torch.equal(x, y), f"data replica {i} differs"

    def walk(trees, specs):
        if isinstance(specs, dict):
            return {k: walk([t[k] for t in trees], specs[k]) for k in specs}
        if isinstance(specs, list):
            return [walk([t[i] for t in trees], s) for i, s in enumerate(specs)]
        if "model" in specs:
            return np.concatenate(trees, axis=specs.index("model"))
        for t in trees[1:]:
            np.testing.assert_array_equal(t, trees[0])  # replicated over 'model'
        return trees[0]

    return walk([r[which] for r in rows[0]], rows[0][0]["specs"][which])


def _close(got, want, **tol):
    g, w = _by_path(got), _by_path(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}")
def test_tp_step_matches_jax_and_one_process(ref, world, case):
    """One TP step against JAX's single-device step and the port's
    one-process step: losses and gradient norms rel 1e-4, the updated G
    rtol 1e-4 / atol 1e-6, D rtol 1e-2 / atol 5e-4, the step's kernels
    (rtol 1e-5 / atol 1e-6), D's state against the one-process step."""
    mode = case[1]
    got = {w: _assemble(world, case, w) for w in ("g", "d", "ds")}
    metrics = world[0][case]["metrics"]
    for res in world:
        assert res[case]["metrics"] == metrics  # every rank logs the global values
    for label in ("jax", "port"):
        want = ref[mode][label]
        for k, v in want["metrics"].items():
            assert metrics[k] == pytest.approx(v, rel=LOSS_REL), (label, k)
        _close(got["g"], want["g"], **G_TOL)
        _close(got["d"], want["d"], **D_TOL)
        np.testing.assert_allclose(world[0][case]["kernels"], want["kernels"],
                                   rtol=1e-5, atol=1e-6)
    _close(got["ds"], ref[mode]["port"]["ds"], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ (1, 1) mesh
@pytest.fixture
def gloo_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["chain", "compose"])
def test_one_by_one_mesh_is_the_plain_step(ref, gloo_of_one, mode):
    """Two steps on a (1, 1) mesh over a gloo group of one (every model and
    data collective runs) equal two plain steps bit for bit: parameters,
    D state, Adam moments, losses and gradient norms."""
    cfg = tp_jobs.config(mode)
    hr, lr = torch.from_numpy(ref["hr"]), torch.from_numpy(ref["lr"])
    mesh = tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.model_group is not None and mesh.shape == {"data": 1, "model": 1}
    plain = tp_jobs.initial_state(cfg, ref["init"])
    tp = tgs.shard_state(mesh, tp_jobs.initial_state(cfg, ref["init"]))
    assert tgs.sharded_axis(tp.g_params["layers"][0]) == 1
    step = tsk.make_train_step(cfg)
    for _ in range(2):
        plain, m_p = step(plain, hr, lr)
        with tmesh.data_parallel(mesh):
            assert tmesh.model_mesh() is mesh
            tp, m_t = step(tp, tmesh.shard_batch(mesh, ref["hr"]),
                           tmesh.shard_batch(mesh, ref["lr"]))
        for k in tp_jobs.METRICS:
            assert float(m_t[k]) == float(m_p[k]), k
    for field in ("g_params", "d_params", "d_state", "g_opt_state", "d_opt_state"):
        for a, b in zip(tree_leaves(getattr(tp, field)), tree_leaves(getattr(plain, field))):
            assert torch.equal(a, b), field


def test_model_collectives_are_the_identity_without_a_model_mesh():
    x = torch.arange(6.0, requires_grad=True)
    for fn in (tmesh.copy_to_model, tmesh.reduce_from_model):
        assert fn(x) is x
    assert tmesh.gather_from_model(x, 0) is x
    one = tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    with tmesh.data_parallel(one):  # no process group: no collectives
        assert tmesh.model_mesh() is None and tmesh.copy_to_model(x) is x
