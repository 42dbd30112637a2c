"""The compiled gradient step (rtc_tpu_torch/diff/render_grad.py through
render/compiled.py) on the CPU, and the fixed-shape backward of the
closest-hit autograd Functions (render/integrator.py _pull).

The graphs run on the card (tests/test_torch_cuda.py, chip_smoke.py phase
19). Here the graphed route is forced and the CUDA graph replaced by
tests/test_torch_compiled.py's stand-in, which replays by running the
captured function on the graph's static inputs: loss_and_grad and the
train step through the cache equal the eager ones bit for bit, one
capture serving every call of a key, and loss_and_grad equals rtc_tpu's
jitted one in f64. The route rules; and every Function's gradients,
byte-equal to those of the backward it replaces (nonzero_pull below,
which gathered the hit rays with torch.nonzero), with no host sync.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtc_tpu.diff import render_grad as JRG
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.diff import render_grad as RG
from rtc_tpu_torch.models.scenes import REGISTRY, _cam, cow_herd_world
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import compiled, integrator
from rtc_tpu_torch.render.camera import camera_rays
from rtc_tpu_torch.scene.compile import TENSOR_FIELDS, compile_scene, scene_from_numpy
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import EPSILON
from test_torch_compiled import REPLAY_SPANS, cpu_graphs, recorded  # noqa: F401 (a fixture)

torch.set_num_threads(2)

PERTURB = {"mat_color": -0.3, "light_intensity": -0.3}


def nonzero_pull(ctx, lead, grads, refined):
    """integrator._pull as it was before its shapes were the wavefront's:
    the hit rays gathered by torch.nonzero, the closed form evaluated on
    them alone. The reference of the bytes the new backward keeps."""
    *inputs, win = ctx.saved_tensors
    needs = ctx.needs_input_grad[lead:]
    if not any(needs):
        return (None,) * (lead + len(inputs))
    rays = torch.nonzero(win >= 0)[:, 0]
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        ys = refined(*(x.double().index_select(0, rays) for x in xs[:2]),
                     *(x.double() for x in xs[2:]), win.index_select(0, rays).long())
        pairs = [(y, g.double().index_select(0, rays))
                 for y, g in zip(ys, grads) if y.requires_grad]
        got = iter(torch.autograd.grad(
            [y for y, _ in pairs], [x for x, n in zip(xs, needs) if n],
            [g for _, g in pairs], allow_unused=True))
    return (None,) * lead + tuple(next(got) if n else None for n in needs)


def _rays(cam, dtype=torch.float32):
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, dtype)
    return o.contiguous(), d.contiguous()


# --- the fixed-shape backward of every Function --------------------------------

def _flat(s):
    return (s.tri_p1, s.tri_e1, s.tri_e2)


def _case(name, s):
    """(Function, search, differentiable tables, lead arguments) of one
    Function on scene s; the search is the kernel's wrapper, which takes
    its plain version on CPU tensors."""
    leaf, I = s.static.cluster_size, integrator
    if name == "K7a":
        return (I.KernelClosest, lambda *x: mi.mesh_closest_hit_elementwise(
            *x, s.cluster_aabb, s.super_aabb, leaf, EPSILON), _flat(s), ())
    if name == "K1 with_n":
        return (I.KernelClosestN, lambda *x: mi.mesh_closest_hit(
            *x, s.cluster_aabb, leaf, EPSILON), (*_flat(s), s.tri_n), ())
    if name == "K1 with_uv streamed":
        return (I.KernelClosestUv, lambda *x: mi.closest_hit_blocked(
            *x, s.cluster_aabb, mi._blocked(s.tri_p1, leaf, 16 * leaf), leaf, EPSILON,
            want_uv=True), _flat(s), ())
    if name == "K1 with_sn":
        return (I.KernelClosestSn, lambda *x: mi.mesh_closest_hit_sn(
            *x, s.cluster_aabb, leaf, EPSILON), (*_flat(s), I.corner_normals(s)), ())
    if name == "K3":
        return (I.KernelClosestShadow, lambda *x: mi.mesh_closest_shadow(
            *x, s.cluster_aabb, s.light_pos, leaf, EPSILON, occ=s.occ),
            (*_flat(s), s.tri_n), ())
    if name == "K3 with_sn":
        return (I.KernelClosestShadowSn, lambda *x: mi.mesh_closest_shadow_sn(
            *x, s.cluster_aabb, s.light_pos, leaf, EPSILON, occ=s.occ),
            (*_flat(s), I.corner_normals(s)), ())
    tl, st = s.tlas, s.static
    smooth = name == "K5 with_sn"
    kernel = mi.mesh_closest_hit_tlas_sn if smooth else mi.mesh_closest_hit_tlas
    rest = (tl.inst_aabb, tl.inst_mesh, tl.inst_obj, leaf, st.tlas_cm, EPSILON)
    return ((I.KernelClosestTlasSn if smooth else I.KernelClosestTlas),
            lambda o, d, p1, e1, e2, n, ab: kernel(o, d, p1, e1, e2, n, tl.caabb, ab, *rest),
            (tl.p1, tl.e1, tl.e2, tl.sn if smooth else tl.n, tl.inst_ab),
            (st.tlas_cm * leaf, tl.inst_mesh))


CASE_SCENES = {"K7a": "teapot", "K1 with_n": "teapot",
               "K1 with_uv streamed": "teapot_smooth", "K1 with_sn": "teapot_smooth",
               "K3": "teapot", "K3 with_sn": "teapot_smooth", "K5": "herd",
               "K5 with_sn": "herd_smooth"}


@pytest.fixture(scope="module")
def case_scenes():
    """teapot and teapot_smooth at 24x12 and the 3x3 herd, flat and
    smooth, at 24x12, f32 on the CPU, with every ray of the frame (hits
    and misses)."""
    out = {}
    for name in ("teapot", "teapot_smooth"):
        world, cam = REGISTRY[name](24)
        out[name] = (compile_scene(world, device="cpu"), *_rays(cam))
    cam = _cam(24, [0, 10, -18], [0, 3, 2])
    for name, smooth in (("herd", False), ("herd_smooth", True)):
        out[name] = (compile_scene(cow_herd_world(3, 3, smooth), device="cpu"), *_rays(cam))
    return out


def _grads(name, case_scenes):
    """Every input's gradient of sum(t * w0) + sum(n * w) (uv * w for K1
    with_uv) through the Function, every input requiring grad: the
    incoming gradients are not zero on the miss rays."""
    scene, o, d = case_scenes[CASE_SCENES[name]]
    fn, search, tabs, lead = _case(name, scene)
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(o.shape[0], 4))
                         .astype(np.float32))
    xs = [x.detach().clone().requires_grad_() for x in (o, d, *tabs)]
    outs = fn.apply(search, EPSILON, *lead, *xs)
    loss = (outs[0] * w[:, 3]).sum()
    for vec in (y for y in outs[2:] if y.is_floating_point()):
        loss = loss + (vec * w[:, :vec.shape[1]]).sum()
    return outs, loss, xs


@pytest.mark.parametrize("miss_rows", ["spread", "zero"])
@pytest.mark.parametrize("name", list(CASE_SCENES))
def test_function_gradients_are_the_nonzero_backwards_bytes(case_scenes, monkeypatch,
                                                            name, miss_rows):
    """The fixed-shape backward gives the bytes of the backward it
    replaced, for every input of every Function, with the misses' stand-in
    rows spread over the table or all on row 0."""
    if miss_rows == "zero":
        monkeypatch.setattr(integrator, "_stand_in", lambda win, rows: 0)
    outs, loss, xs = _grads(name, case_scenes)
    hits = int((outs[1] >= 0).sum())
    assert 0 < hits < outs[1].shape[0], "the rays must hit and miss"
    got = torch.autograd.grad(loss, xs)
    with monkeypatch.context() as m:
        m.setattr(integrator, "_pull", nonzero_pull)
        _, loss, xs = _grads(name, case_scenes)
        want = torch.autograd.grad(loss, xs)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.numpy().tobytes() == b.numpy().tobytes(), f"input {k}"
    assert all(float(g.abs().sum()) > 0 for g in got)


def test_the_backward_makes_no_host_sync(case_scenes, monkeypatch):
    """Every Function's backward runs with torch.nonzero, .item() and
    .tolist() raising (what a CUDA graph's capture refuses)."""
    cases = {name: _grads(name, case_scenes) for name in CASE_SCENES}

    def refuse(*a, **k):
        raise RuntimeError("a host sync")

    for target, attr in ((torch, "nonzero"), (torch.Tensor, "nonzero"),
                         (torch.Tensor, "item"), (torch.Tensor, "tolist")):
        monkeypatch.setattr(target, attr, refuse)
    with pytest.raises(RuntimeError, match="a host sync"):
        torch.nonzero(torch.ones(2))
    for name, (_, loss, xs) in cases.items():
        got = torch.autograd.grad(loss, xs)
        assert all(bool(torch.isfinite(g).all()) for g in got), name


def test_a_miss_on_a_padding_row_adds_a_finite_zero():
    """Three rays miss a one-triangle table padded to four rows, and their
    stand-in rows are the padding rows (e1 = e2 = 0): every gradient is
    finite, the padding rows' are exactly +0, and so are the misses' o
    and d gradients."""
    p1 = torch.zeros((4, 3))
    e1, e2 = torch.zeros((4, 3)), torch.zeros((4, 3))
    p1[0] = torch.tensor([-1.0, -1.0, 0.0])
    e1[0], e2[0] = torch.tensor([2.0, 0.0, 0.0]), torch.tensor([0.0, 2.0, 0.0])
    n = torch.zeros((4, 3))
    n[0, 2] = -1.0
    o = torch.tensor([[-0.5, -0.4, -5.0], [5.0, 5.0, -5.0], [0.0, 0.0, 5.0],
                      [1e12, 1e12, 1e12]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0],
                      [0.5773502692] * 3])
    xs = [x.clone().requires_grad_() for x in (o, d, p1, e1, e2, n)]
    t, idx, nn = integrator.KernelClosestN.apply(
        lambda *x: mi.closest_hit_plain(*x, EPSILON), EPSILON, *xs)
    assert idx.tolist() == [0, -1, -1, -1]
    loss = (t * torch.tensor([1.0, -2.0, 3.0, -4.0])).sum() + (nn * 3.0).sum()
    got = torch.autograd.grad(loss, xs)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for g in got[:2]:
        assert g[1:].numpy().tobytes() == bytes(36)
        assert float(g[0].abs().sum()) > 0
    for g in got[2:]:
        assert g[1:].numpy().tobytes() == bytes(36)


# --- the graphed loss_and_grad and train step ---------------------------------

@pytest.fixture(scope="module")
def cow_frames():
    """The cow at 16x8 in f32 and f64 on the CPU: its scene, two
    wavefronts (the camera's rays, and the same rays turned slightly),
    and their targets rendered with PERTURB's lowered material and light."""
    out = {}
    world, cam = REGISTRY["cow"](16)
    for dtype in (torch.float32, torch.float64):
        scene = compile_scene(world, dtype=dtype, device="cpu")
        cfg = RenderConfig(dtype="float64" if dtype == torch.float64 else "float32")
        o, d = _rays(cam, dtype)
        d2 = torch.nn.functional.normalize(d + torch.tensor([0.01, -0.02, 0.0], dtype=dtype),
                                           dim=1)
        base = RG.extract_params(scene)
        moved = {k: base[k].detach() + v for k, v in PERTURB.items()}
        with torch.no_grad():
            target_scene = RG.inject_params(scene, moved)
            waves = [(o, dd, integrator.color_at(target_scene, o, dd, cfg)) for dd in (d, d2)]
        out[dtype] = scene, cfg, waves
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_graphed_loss_and_grad_equals_eager(cow_frames, cpu_graphs, dtype):
    """Two wavefronts under one key make one capture, and each call's loss
    and gradients equal the eager call's bit for bit; the results are the
    caller's own, apart from the graph's outputs."""
    scene, cfg, waves = cow_frames[dtype]
    params = RG.extract_params(scene, RG.DEFAULT_PARAMS + ("tri_n",))
    with compiled.eager():
        want = [RG.loss_and_grad(params, scene, *w, cfg) for w in waves]
    assert not torch.equal(want[0][0], want[1][0])
    captures = cpu_graphs["captures"]
    for k in (0, 1, 0, 1):
        loss, grads = RG.loss_and_grad(params, scene, *waves[k], cfg)
        assert loss.numpy().tobytes() == want[k][0].numpy().tobytes()
        assert set(grads) == set(params)
        for name, g in grads.items():
            assert g.numpy().tobytes() == want[k][1][name].numpy().tobytes(), name
    assert cpu_graphs["captures"] == captures + 1
    assert float(grads["tri_n"].abs().sum()) > 0 and not bool(grads["pat_b"].any())
    key = next(k for k in compiled._CACHE if k[1] == "grad")
    assert compiled._CACHE[key].replays == 3
    assert compiled.ROUTES["loss_and_grad: graphed"] >= 4


def test_graphed_kernel_route_pulls_through_the_functions(cow_frames, cpu_graphs,
                                                          monkeypatch):
    """The f32 cow on the kernel route (K3's Function, its plain version
    on the CPU), tri_n a parameter so its backward runs inside the graph:
    replays equal the eager calls bit for bit."""
    scene, cfg, waves = cow_frames[torch.float32]
    monkeypatch.setattr(integrator, "mesh_impl_for", lambda *a: "kernel")
    pulls = []
    monkeypatch.setattr(integrator, "_pull",
                        lambda *a, pull=integrator._pull: pulls.append(1) or pull(*a))
    params = RG.extract_params(scene, RG.DEFAULT_PARAMS + ("tri_n",))
    with compiled.eager():
        want = [RG.loss_and_grad(params, scene, *w, cfg) for w in waves]
    assert pulls
    for k in (0, 1, 1):
        loss, grads = RG.loss_and_grad(params, scene, *waves[k], cfg)
        assert torch.equal(loss, want[k][0])
        assert all(torch.equal(grads[n], want[k][1][n]) for n in params)
    assert float(grads["tri_n"].abs().sum()) > 0


def test_graphed_loss_and_grad_matches_rtc_tpu_f64(cpu_graphs):
    """The graphed loss_and_grad of the f64 cow (material, light, patterns
    and normals) equals rtc_tpu's jitted one at 1e-9, on the same numpy
    inputs, on the first call and on a replay."""
    world, cam = JAX_REGISTRY["cow"](16)
    js = jax_compile_scene(world, dtype=np.float64)
    dt = jnp.float64
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, dt), cam.hsize, cam.vsize,
                           cam.half_width, cam.half_height, cam.pixel_size, dt)
    target = jnp.zeros_like(o) + 0.25
    names = RG.DEFAULT_PARAMS + ("tri_n",)
    jparams = JRG.extract_params(js, names)
    jloss, jgrads = JRG.loss_and_grad(jparams, js, o, d, target,
                                      JaxRenderConfig(dtype="float64", mesh_impl="bruteforce"))
    scene = scene_from_numpy({f: np.asarray(getattr(js, f)) for f in TENSOR_FIELDS},
                             js.static._asdict(), device="cpu")
    params = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in jparams.items()}
    t = lambda a: torch.from_numpy(np.array(a))
    for _ in range(2):
        loss, grads = RG.loss_and_grad(params, scene, t(o), t(d), t(target),
                                       RenderConfig(dtype="float64", mesh_impl="bruteforce"))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-9, atol=0)
        for k in names:
            np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                       rtol=1e-9, atol=1e-9, err_msg=k)
    assert compiled.ROUTES["loss_and_grad: graphed"] >= 2
    assert len(compiled._CACHE) == 1


def _trajectory(scene, cfg, waves, steps, momentum=0.9):
    """steps SGD-with-momentum steps on PERTURB's parameters over the two
    wavefronts in turn: each step's loss and the parameters after it."""
    params = RG.extract_params(scene, tuple(PERTURB))
    step = RG.make_train_step(torch.optim.SGD(params.values(), lr=0.5, momentum=momentum),
                              cfg)
    out = []
    for k in range(steps):
        loss = step(params, scene, *waves[k % 2])
        out.append((loss, {n: v.detach().clone() for n, v in params.items()}))
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_graphed_train_step_follows_the_eager_trajectory(cow_frames, cpu_graphs, dtype):
    """Three graphed SGD-with-momentum steps take the eager steps bit for
    bit: the first call takes exactly one step (its eager run; the capture
    moves nothing), and each replay one more."""
    scene, cfg, waves = cow_frames[dtype]
    with compiled.eager():
        want = _trajectory(scene, cfg, waves, 3)
    captures = cpu_graphs["captures"]
    got = _trajectory(scene, cfg, waves, 3)
    assert cpu_graphs["captures"] == captures + 1
    for (loss, params), (w_loss, w_params) in zip(got, want):
        assert loss.numpy().tobytes() == w_loss.numpy().tobytes()
        for n in params:
            assert params[n].numpy().tobytes() == w_params[n].numpy().tobytes(), n
    assert not torch.equal(got[0][1]["mat_color"], got[1][1]["mat_color"])
    assert float(got[2][0]) < float(got[0][0])
    key = next(k for k in compiled._CACHE if k[1] == "step")
    graph = compiled._CACHE[key]
    assert graph.replays == 2 and len(graph.held) > 2  # the parameters and momenta


@pytest.mark.parametrize("call", ["loss_and_grad", "train_step"])
def test_gradient_calls_record_their_spans(cow_frames, cpu_graphs, call):
    """A replayed loss_and_grad or train step is one root of its name over
    the route, the graph's lookup, the inputs' fill, the replay and the
    output's copy, in that order. The stand-in graph's replay reruns the
    step, so its backward's object rows' sums (one a shading node, the
    plain path in f64) sit under the replay; a card's replay runs no
    Python and records none."""
    scene, cfg, waves = cow_frames[torch.float64]
    params = RG.extract_params(scene, tuple(PERTURB))
    step = RG.make_train_step(torch.optim.SGD(params.values(), lr=0.5, momentum=0.9), cfg)
    fn = {"loss_and_grad": lambda: RG.loss_and_grad(params, scene, *waves[0], cfg),
          "train_step": lambda: step(params, scene, *waves[0])}[call]
    fn()
    spans = [(f"rtc.{call}", -1), ("rtc.route", 0)] + [(n, 0) for n in REPLAY_SPANS]
    replay = spans.index(("rtc.graph.replay", 0))
    spans[replay + 1:replay + 1] = [("rtc.object_rows.plain", replay)] * 2
    assert recorded(fn) == spans


def test_new_parameter_tensors_capture_again(cow_frames, cpu_graphs):
    """A train step's graph holds the parameters and the optimizer's
    state; parameters that now lie elsewhere make the next call capture
    again."""
    scene, cfg, waves = cow_frames[torch.float64]
    params = RG.extract_params(scene, tuple(PERTURB))
    opt = torch.optim.SGD(params.values(), lr=0.5, momentum=0.9)
    step = RG.make_train_step(opt, cfg)
    captures = cpu_graphs["captures"]
    step(params, scene, *waves[0])
    step(params, scene, *waves[0])
    assert cpu_graphs["captures"] == captures + 1
    new = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    opt.param_groups[0]["params"] = list(new.values())
    step(new, scene, *waves[0])
    assert cpu_graphs["captures"] == captures + 2


# --- the routes -----------------------------------------------------------------

def test_step_routes(cow_frames, cpu_graphs):
    """Graphed unless triangle rows are parameters, or the optimizer has
    capturable=False; every call inside eager() takes the eager route. A
    call on an eager route captures nothing, and ROUTES counts each."""
    scene, cfg, waves = cow_frames[torch.float64]
    rows = RG.extract_params(scene, ("mat_color", "tri_p1"))
    mat = RG.extract_params(scene, ("mat_color",))
    route = compiled.step_route
    assert route(scene, cfg, mat) == compiled.GRAPHED
    assert route(scene, cfg, rows).startswith("eager: geometry parameters tri_p1")
    for opt, want in (
            (torch.optim.Adam(mat.values()), "eager: Adam with capturable=False"),
            (torch.optim.AdamW(mat.values()), "eager: AdamW with capturable=False"),
            (torch.optim.Adam(mat.values(), capturable=True), compiled.GRAPHED),
            (torch.optim.SGD(mat.values(), lr=0.1), compiled.GRAPHED)):
        assert route(scene, cfg, mat, opt).startswith(want), opt
    compiled.ROUTES.clear()
    captures = cpu_graphs["captures"]
    RG.loss_and_grad(rows, scene, *waves[0], cfg)
    RG.make_train_step(torch.optim.Adam(mat.values()), cfg)(mat, scene, *waves[0])
    with compiled.eager():
        RG.loss_and_grad(mat, scene, *waves[0], cfg)
        RG.make_train_step(torch.optim.SGD(mat.values(), lr=0.1), cfg)(mat, scene, *waves[0])
    assert cpu_graphs["captures"] == captures and not compiled._CACHE
    assert compiled.ROUTES == {
        "loss_and_grad: " + route(scene, cfg, rows): 1,
        "train_step: eager: Adam with capturable=False (its step count lives on the host)": 1,
        "loss_and_grad: " + compiled.EAGER_CONTEXT: 1,
        "train_step: " + compiled.EAGER_CONTEXT: 1}


def test_the_cpu_is_eager(cow_frames):
    scene, cfg, waves = cow_frames[torch.float64]
    params = RG.extract_params(scene, tuple(PERTURB))
    assert compiled.step_route(scene, cfg, params) == "eager: the CPU"
    compiled.ROUTES.clear()
    RG.loss_and_grad(params, scene, *waves[0], cfg)
    assert compiled.ROUTES == {"loss_and_grad: eager: the CPU": 1}
