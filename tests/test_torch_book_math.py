"""The book's math tables against rtc_tpu_torch on the CPU in float64:
tuples, matrices, transformations, rays, colors, materials and patterns
(the expectations of tests/test_tuples.py, test_matrices.py,
test_transformations.py, test_rays.py, test_colors.py, test_materials.py
and test_patterns.py, with their numbers and the book's 1e-5), and each
function of the port's ops/tuples, ops/matrices, ops/rays, ops/colors and
the packed vec, transforms, lighting and intersect.aabb functions against
rtc_tpu's on seeded batches, at 1e-12."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_almost_eq
from rtc_tpu.ops import colors as JC
from rtc_tpu.ops import intersect as JI
from rtc_tpu.ops import lighting as JL
from rtc_tpu.ops import matrices as JM
from rtc_tpu.ops import rays as JR
from rtc_tpu.ops import transforms as JX
from rtc_tpu.ops import tuples as JT
from rtc_tpu.ops import vec as JV
from rtc_tpu_torch.ops import colors as C
from rtc_tpu_torch.ops import intersect as I
from rtc_tpu_torch.ops import lighting as L
from rtc_tpu_torch.ops import matrices as M
from rtc_tpu_torch.ops import patterns as P
from rtc_tpu_torch.ops import rays as R
from rtc_tpu_torch.ops import transforms as X
from rtc_tpu_torch.ops import tuples as T
from rtc_tpu_torch.ops import vec
from rtc_tpu_torch.scene import shapes as S
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.scene.materials import (Material, stripe_pattern,
                                           test_pattern)
from rtc_tpu_torch.scene.world import World

torch.set_num_threads(2)

PI = math.pi
S2 = math.sqrt(2.0)
S3 = math.sqrt(3.0)
CPU = dict(device="cpu")
F64 = torch.float64


def tup(x, y, z, w):
    return T.tuple4(x, y, z, w, **CPU)


def point(x, y, z):
    return T.point(x, y, z, **CPU)


def vector(x, y, z):
    return T.vector(x, y, z, **CPU)


def mat(rows):
    return torch.tensor(rows, dtype=F64)


# --- tuples (tests/test_tuples.py; reference: src/tuple.rs:155-352) ----------

def test_a_tuple_with_w_eq_1_is_a_point():
    t = tup(4.3, -4.2, 3.1, 1.0)
    assert_almost_eq(t, [4.3, -4.2, 3.1, 1.0], eps=1e-12)
    assert bool(T.is_point(t))
    assert not bool(T.is_vector(t))


def test_a_tuple_with_w_eq_0_is_a_vector():
    t = tup(4.3, -4.2, 3.1, 0.0)
    assert not bool(T.is_point(t))
    assert bool(T.is_vector(t))


@pytest.mark.parametrize("make,w", [(point, 1.0), (vector, 0.0)], ids=["point", "vector"])
def test_point_and_vector_create_tuples(make, w):
    t = make(4.0, -4.0, 3.0)
    assert_almost_eq(t, [4.0, -4.0, 3.0, w])
    assert t.dtype == F64 and t.device.type == "cpu"


def test_adding_two_tuples():
    assert_almost_eq(tup(3.0, -2.0, 5.0, 1.0) + tup(-2.0, 3.0, 1.0, 0.0), [1.0, 1.0, 6.0, 1.0])


@pytest.mark.parametrize("a,b,expected", [
    (lambda: point(3, 2, 1), lambda: point(5, 6, 7), lambda: vector(-2, -4, -6)),
    (lambda: point(3, 2, 1), lambda: vector(5, 6, 7), lambda: point(-2, -4, -6)),
    (lambda: vector(3, 2, 1), lambda: vector(5, 6, 7), lambda: vector(-2, -4, -6)),
    (lambda: vector(0, 0, 0), lambda: vector(1, -2, 3), lambda: vector(-1, 2, -3)),
], ids=["point-point", "point-vector", "vector-vector", "zero-vector"])
def test_subtracting_tuples(a, b, expected):
    assert_almost_eq(a() - b(), expected())


def test_negating_a_tuple():
    assert_almost_eq(-tup(1, -2, 3, -4), [-1.0, 2.0, -3.0, 4.0])


@pytest.mark.parametrize("op,expected", [
    (lambda t: t * 3.5, [3.5, -7.0, 10.5, -14.0]),
    (lambda t: t * 0.5, [0.5, -1.0, 1.5, -2.0]),
    (lambda t: t / 2.0, [0.5, -1.0, 1.5, -2.0]),
], ids=["scalar", "fraction", "divide"])
def test_scaling_a_tuple(op, expected):
    assert_almost_eq(op(tup(1, -2, 3, -4)), expected)


def test_magnitudes_of_unit_vectors():
    for v in ([1, 0, 0], [0, 1, 0], [0, 0, 1]):
        assert_almost_eq(T.magnitude(vector(*v)), 1.0)


@pytest.mark.parametrize("v", [(1, 2, 3), (-1, -2, -3)])
def test_computing_the_magnitude_of_vector_1_2_3(v):
    assert_almost_eq(T.magnitude(vector(*v)), math.sqrt(14.0))


def test_normalizing_vector_4_0_0_gives_1_0_0():
    assert_almost_eq(T.normalize(vector(4, 0, 0)), vector(1, 0, 0))


def test_normalizing_vector_1_2_3():
    norm = T.normalize(vector(1, 2, 3))
    assert_almost_eq(norm, vector(0.26726124, 0.5345225, 0.8017837))
    assert_almost_eq(T.magnitude(norm), 1.0)


def test_normalizing_zero_vector_gives_zero():
    assert_almost_eq(T.normalize(vector(0, 0, 0)), vector(0, 0, 0))


def test_the_dot_product_of_two_tuples():
    assert_almost_eq(T.dot(vector(1, 2, 3), vector(2, 3, 4)), 20.0)


def test_the_cross_product_of_two_vectors():
    a, b = vector(1, 2, 3), vector(2, 3, 4)
    assert_almost_eq(T.cross(a, b), vector(-1, 2, -1))
    assert_almost_eq(T.cross(b, a), vector(1, -2, 1))


def test_cross_of_a_batch_of_three_is_per_row():
    """torch.cross without dim takes the first axis of size 3: a (3, 4)
    batch of vectors must still cross row by row."""
    a = torch.stack([vector(1, 2, 3), vector(0, 1, 0), vector(1, 0, 0)])
    b = torch.stack([vector(2, 3, 4), vector(0, 0, 1), vector(0, 1, 0)])
    want = torch.stack([vector(-1, 2, -1), vector(1, 0, 0), vector(0, 0, 1)])
    assert_almost_eq(T.cross(a, b), want)
    assert_almost_eq(vec.cross(a[:, :3], b[:, :3]), want[:, :3])


@pytest.mark.parametrize("v,n,expected", [
    ((1, -1, 0), (0, 1, 0), (1, 1, 0)),
    ((0, -1, 0), (S2 / 2, S2 / 2, 0), (1, 0, 0)),
], ids=["45_degrees", "slanted_surface"])
def test_reflecting_a_vector(v, n, expected):
    assert_almost_eq(T.reflect(vector(*v), vector(*n)), vector(*expected))


def test_vec3_ops_match_tuple_ops():
    a = torch.tensor([1.0, 2.0, 3.0], dtype=F64)
    b = torch.tensor([2.0, 3.0, 4.0], dtype=F64)
    assert_almost_eq(vec.dot(a, b), 20.0)
    assert_almost_eq(vec.cross(a, b), [-1.0, 2.0, -1.0])
    assert_almost_eq(vec.magnitude(a), math.sqrt(14.0))
    assert_almost_eq(vec.normalize(torch.tensor([4.0, 0.0, 0.0], dtype=F64)), [1.0, 0.0, 0.0])
    assert_almost_eq(vec.normalize(torch.zeros(3, dtype=F64)), [0.0, 0.0, 0.0])
    s = math.sqrt(2.0) / 2.0
    assert_almost_eq(vec.reflect(torch.tensor([0.0, -1.0, 0.0], dtype=F64),
                                 torch.tensor([s, s, 0.0], dtype=F64)), [1.0, 0.0, 0.0])


def test_vec3_ops_batched():
    a = torch.arange(12.0, dtype=F64).reshape(4, 3)
    a[0] = 0.0
    mags = vec.magnitude(vec.normalize(a))
    assert_almost_eq(mags[1:], np.ones(3))
    assert_almost_eq(mags[0], 0.0)


# --- matrices (tests/test_matrices.py; reference: src/matrix.rs:230-560) -----

def test_constructing_and_inspecting_a_4x4_matrix():
    m = mat([[1, 2, 3, 4], [5.5, 6.5, 7.5, 8.5], [9, 10, 11, 12], [13.5, 14.5, 15.5, 16.5]])
    assert m[0][0] == 1 and m[0][3] == 4 and m[1][0] == 5.5
    assert m[1][2] == 7.5 and m[2][2] == 11 and m[3][0] == 13.5 and m[3][2] == 15.5


def test_2x2_and_3x3_representable():
    m2 = mat([[-3, 5], [1, -2]])
    assert m2[0][0] == -3 and m2[0][1] == 5 and m2[1][0] == 1 and m2[1][1] == -2
    m3 = mat([[-3, 5, 0], [1, -2, -7], [0, 1, 1]])
    assert m3[0][0] == -3 and m3[1][1] == -2 and m3[2][2] == 1


def test_matrix_equality():
    a = mat([[1, 2, 3, 4], [5, 6, 7, 8], [9, 8, 7, 6], [5, 4, 3, 2]])
    assert bool(M.almost_equal(a, a.clone()))
    c = a.clone()
    c[0, 0] = 2
    c[3, 3] = 1
    assert not bool(M.almost_equal(a, c))


def test_multiplying_two_matrices():
    a = mat([[1, 2, 3, 4], [5, 6, 7, 8], [9, 8, 7, 6], [5, 4, 3, 2]])
    b = mat([[-2, 1, 2, 3], [3, 2, 1, -1], [4, 3, 6, 5], [1, 2, 7, 8]])
    expected = [[20, 22, 50, 48], [44, 54, 114, 108], [40, 58, 110, 102], [16, 26, 46, 42]]
    assert_almost_eq(M.matmul(a, b), expected)


def test_a_matrix_multiplied_by_a_tuple():
    a = mat([[1, 2, 3, 4], [2, 4, 4, 2], [8, 6, 4, 1], [0, 0, 0, 1]])
    assert_almost_eq(M.mul_tuple(a, tup(1, 2, 3, 1)), [18, 24, 33, 1])


def test_multiplying_a_matrix_by_the_identity_matrix():
    a = mat([[0, 1, 2, 4], [1, 2, 4, 8], [2, 4, 8, 16], [4, 8, 16, 32]])
    assert_almost_eq(M.matmul(a, M.identity(4, **CPU)), a)


def test_multiplying_the_identity_matrix_by_a_tuple():
    a = tup(1, 2, 3, 4)
    assert_almost_eq(M.mul_tuple(M.identity(4, **CPU), a), a)


def test_transposing_a_matrix():
    a = mat([[0, 9, 3, 0], [9, 8, 0, 8], [1, 8, 5, 3], [0, 0, 5, 8]])
    expected = [[0, 9, 1, 0], [9, 8, 8, 0], [3, 0, 5, 5], [0, 8, 3, 8]]
    assert_almost_eq(M.transpose(a), expected)


def test_transposing_the_identity_matrix():
    assert_almost_eq(M.transpose(M.identity(4, **CPU)), np.eye(4))


def test_calculating_the_determinant_of_a_2x2_matrix():
    assert_almost_eq(M.determinant(mat([[1, 5], [-3, 2]])), 17.0)


@pytest.mark.parametrize("m,row,col,expected", [
    ([[1, 5, 0], [-3, 2, 7], [0, 6, -3]], 0, 2, [[-3, 2], [0, 6]]),
    ([[-6, 1, 1, 6], [-8, 5, 8, 6], [-1, 0, 8, 2], [-7, 1, -1, 1]], 2, 1,
     [[-6, 1, 6], [-8, 8, 6], [-7, -1, 1]]),
], ids=["3x3", "4x4"])
def test_a_submatrix_is_one_size_smaller(m, row, col, expected):
    assert_almost_eq(M.submatrix(mat(m), row, col), expected)


def test_calculating_a_minor_of_a_3x3_matrix():
    a = mat([[3, 5, 0], [2, -1, -7], [6, -1, 5]])
    assert_almost_eq(M.determinant(M.submatrix(a, 1, 0)), 25.0)
    assert_almost_eq(M.minor(a, 1, 0), 25.0)


def test_calculating_a_cofactor_of_a_3x3_matrix():
    a = mat([[3, 5, 0], [2, -1, -7], [6, -1, 5]])
    assert_almost_eq(M.minor(a, 0, 0), -12.0)
    assert_almost_eq(M.cofactor(a, 0, 0), -12.0)
    assert_almost_eq(M.minor(a, 1, 0), 25.0)
    assert_almost_eq(M.cofactor(a, 1, 0), -25.0)


@pytest.mark.parametrize("m,cofactors,det", [
    ([[1, 2, 6], [-5, 8, -4], [2, 6, 4]], [56.0, 12.0, -46.0], -196.0),
    ([[-2, -8, 3, 5], [-3, 1, 7, 3], [1, 2, -9, 6], [-6, 7, 7, -9]],
     [690.0, 447.0, 210.0, 51.0], -4071.0),
], ids=["3x3", "4x4"])
def test_calculating_the_determinant(m, cofactors, det):
    a = mat(m)
    for col, want in enumerate(cofactors):
        assert_almost_eq(M.cofactor(a, 0, col), want)
    assert_almost_eq(M.determinant(a), det)


def test_testing_an_invertible_matrix_for_invertibility():
    a = mat([[6, 4, 4, 4], [5, 5, 7, 6], [4, -9, 3, -7], [9, 1, 7, -6]])
    assert_almost_eq(M.determinant(a), -2120.0)
    assert bool(M.is_invertible(a))


def test_testing_a_noninvertible_matrix_for_invertibility():
    a = mat([[-4, 2, -2, -3], [9, 6, 2, 6], [0, -5, 1, -5], [0, 0, 0, 0]])
    assert_almost_eq(M.determinant(a), 0.0)
    assert not bool(M.is_invertible(a))


def test_the_inverse_of_a_singular_matrix_is_not_finite():
    """rtc_tpu's inverse gives non-finite values on a singular matrix
    (torch.linalg.inv raises there): the same NaN/inf pattern."""
    a = [[-4, 2, -2, -3], [9, 6, 2, 6], [0, -5, 1, -5], [0, 0, 0, 0]]
    got = M.inverse(mat(a)).numpy()
    want = np.asarray(JM.inverse(np.array(a, dtype=np.float64)))
    assert not np.isfinite(got).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))


def test_calculating_the_inverse_of_a_matrix():
    a = mat([[-5, 2, 6, -8], [1, -5, 1, 8], [7, 7, -6, -7], [1, -3, 7, 4]])
    b = M.inverse(a)
    assert_almost_eq(M.determinant(a), 532.0)
    assert_almost_eq(M.cofactor(a, 2, 3), -160.0)
    assert_almost_eq(b[3][2], -160.0 / 532.0)
    assert_almost_eq(M.cofactor(a, 3, 2), 105.0)
    assert_almost_eq(b[2][3], 105.0 / 532.0)
    assert_almost_eq(b, [
        [0.21805, 0.45113, 0.24060, -0.04511],
        [-0.80827, -1.45677, -0.44361, 0.52068],
        [-0.07895, -0.22368, -0.05263, 0.19737],
        [-0.52256, -0.81391, -0.30075, 0.30639],
    ])


@pytest.mark.parametrize("m,expected", [
    ([[8, -5, 9, 2], [7, 5, 6, 1], [-6, 0, 9, 6], [-3, 0, -9, -4]],
     [[-0.15385, -0.15385, -0.28205, -0.53846],
      [-0.07692, 0.12308, 0.02564, 0.03077],
      [0.35897, 0.35897, 0.43590, 0.92308],
      [-0.69231, -0.69231, -0.76923, -1.92308]]),
    ([[9, 3, 0, 9], [-5, -2, -6, -3], [-4, 9, 6, 4], [-7, 6, 6, 2]],
     [[-0.04074, -0.07778, 0.14444, -0.22222],
      [-0.07778, 0.03333, 0.36667, -0.33333],
      [-0.02901, -0.14630, -0.10926, 0.12963],
      [0.17778, 0.06667, -0.26667, 0.33333]]),
], ids=["another", "third"])
def test_calculating_the_inverse_of_more_matrices(m, expected):
    assert_almost_eq(M.inverse(mat(m)), expected)


def test_multiplying_a_product_by_its_inverse():
    a = mat([[3, -9, 7, 3], [3, -8, 2, -9], [-4, 4, 4, 1], [-6, 5, -1, 1]])
    b = mat([[8, 2, 2, 2], [3, -1, 7, 0], [7, 0, 5, 4], [6, -2, 0, 5]])
    assert_almost_eq(M.matmul(M.matmul(a, b), M.inverse(b)), a)


def test_batched_inverse_matches_loop():
    rng = np.random.default_rng(0)
    batch = rng.normal(size=(5, 4, 4)) + np.eye(4) * 4.0
    binv = M.inverse(torch.from_numpy(batch)).numpy()
    for i in range(5):
        assert_almost_eq(binv[i], np.linalg.inv(batch[i]))


# --- transformations (tests/test_transformations.py;
#     reference: src/transformations.rs:95-320) --------------------------------

def apply(m, t):
    return M.mul_tuple(m, t)


@pytest.mark.parametrize("m,t,expected", [
    (lambda: X.translation(5, -3, 2), lambda: point(-3, 4, 5), lambda: point(2, 1, 7)),
    (lambda: M.inverse(X.translation(5, -3, 2)), lambda: point(-3, 4, 5),
     lambda: point(-8, 7, 3)),
    (lambda: X.translation(5, -3, 2), lambda: vector(-3, 4, 5), lambda: vector(-3, 4, 5)),
    (lambda: X.scaling(2, 3, 4), lambda: point(-4, 6, 8), lambda: point(-8, 18, 32)),
    (lambda: X.scaling(2, 3, 4), lambda: vector(-4, 6, 8), lambda: vector(-8, 18, 32)),
    (lambda: M.inverse(X.scaling(2, 3, 4)), lambda: vector(-4, 6, 8),
     lambda: vector(-2, 2, 2)),
    (lambda: X.scaling(-1, 1, 1), lambda: point(2, 3, 4), lambda: point(-2, 3, 4)),
    (lambda: M.inverse(X.rotation_x(PI / 4)), lambda: point(0, 1, 0),
     lambda: point(0, S2 / 2, -S2 / 2)),
], ids=["translation", "inverse_translation", "translation_ignores_vectors",
        "scaling_point", "scaling_vector", "inverse_scaling", "reflection",
        "inverse_x_rotation"])
def test_applying_a_transformation(m, t, expected):
    assert_almost_eq(apply(m(), t()), expected())


@pytest.mark.parametrize("rot,p,quarter,half", [
    (X.rotation_x, (0, 1, 0), (0, S2 / 2, S2 / 2), (0, 0, 1)),
    (X.rotation_y, (0, 0, 1), (S2 / 2, 0, S2 / 2), (1, 0, 0)),
    (X.rotation_z, (0, 1, 0), (-S2 / 2, S2 / 2, 0), (-1, 0, 0)),
], ids=["x", "y", "z"])
def test_rotating_a_point_around_an_axis(rot, p, quarter, half):
    assert_almost_eq(apply(rot(PI / 4), point(*p)), point(*quarter))
    assert_almost_eq(apply(rot(PI / 2), point(*p)), point(*half))


def test_shearing_transformations():
    p = point(2, 3, 4)
    for args, want in [((1, 0, 0, 0, 0, 0), (5, 3, 4)), ((0, 1, 0, 0, 0, 0), (6, 3, 4)),
                       ((0, 0, 1, 0, 0, 0), (2, 5, 4)), ((0, 0, 0, 1, 0, 0), (2, 7, 4)),
                       ((0, 0, 0, 0, 1, 0), (2, 3, 6)), ((0, 0, 0, 0, 0, 1), (2, 3, 7))]:
        assert_almost_eq(apply(X.shearing(*args), p), point(*want))


def test_individual_transformations_are_applied_in_sequence():
    p2 = apply(X.rotation_x(PI / 2), point(1, 0, 1))
    assert_almost_eq(p2, point(1, -1, 0))
    p3 = apply(X.scaling(5, 5, 5), p2)
    assert_almost_eq(p3, point(5, -5, 0))
    assert_almost_eq(apply(X.translation(10, 5, 7), p3), point(15, 0, 7))


def test_chained_transformations_must_be_applied_in_reverse_order():
    t = M.matmul(M.matmul(X.translation(10, 5, 7), X.scaling(5, 5, 5)), X.rotation_x(PI / 2))
    assert_almost_eq(apply(t, point(1, 0, 1)), point(15, 0, 7))


@pytest.mark.parametrize("args,expected", [
    (([0, 0, 0], [0, 0, -1], [0, 1, 0]), np.eye(4)),
    (([0, 0, 0], [0, 0, 1], [0, 1, 0]), X.scaling(-1, 1, -1)),
    (([0, 0, 8], [0, 0, 0], [0, 1, 0]), X.translation(0, 0, -8)),
    (([1, 3, 2], [4, -2, 8], [1, 1, 0]), np.array([
        [-0.50709, 0.50709, 0.67612, -2.36643],
        [0.76772, 0.60609, 0.12122, -2.82843],
        [-0.35857, 0.59761, -0.71714, 0.00000],
        [0.00000, 0.00000, 0.00000, 1.00000]])),
], ids=["default_orientation", "positive_z", "moves_the_world", "arbitrary"])
def test_the_view_transformation(args, expected):
    assert_almost_eq(X.view_transform(*args), expected)
    # the tensor branch (camera-pose gradients) gives the same matrix
    assert_almost_eq(X.view_transform(*(torch.tensor(a, dtype=F64) for a in args)), expected)


def test_affine_inverse_matches_general_inverse():
    t = M.matmul(M.matmul(X.translation(1, -2, 3), X.rotation_y(0.7)), X.scaling(2.0, 0.5, 4.0))
    assert_almost_eq(X.affine_inverse(t), np.linalg.inv(t.numpy()), eps=1e-9)


def test_transform_points_and_dirs():
    t = X.translation(1, 2, 3)
    p = torch.tensor([[1.0, 1.0, 1.0]], dtype=F64)
    assert_almost_eq(X.transform_points(t, p), [[2.0, 3.0, 4.0]])
    assert_almost_eq(X.transform_dirs(t, p), [[1.0, 1.0, 1.0]])


# --- rays (tests/test_rays.py; reference: src/ray.rs:27-69) ------------------

def test_creating_and_querying_a_ray():
    r = R.ray([1, 2, 3], [4, 5, 6], **CPU)
    assert_almost_eq(r.origin, [1, 2, 3])
    assert_almost_eq(r.direction, [4, 5, 6])


def test_computing_a_point_from_a_distance():
    r = R.ray([2, 3, 4], [1, 0, 0], **CPU)
    for t, want in [(0.0, [2, 3, 4]), (1.0, [3, 3, 4]), (-1.0, [1, 3, 4]), (2.5, [4.5, 3, 4])]:
        assert_almost_eq(R.position(r, t), want)


@pytest.mark.parametrize("m,origin,direction", [
    (X.translation(3, 4, 5), [4, 6, 8], [0, 1, 0]),
    (X.scaling(2, 3, 4), [2, 6, 12], [0, 3, 0]),  # direction NOT renormalized
], ids=["translating", "scaling"])
def test_transforming_a_ray(m, origin, direction):
    r2 = R.transform(R.ray([1, 2, 3], [0, 1, 0], **CPU), m)
    assert_almost_eq(r2.origin, origin)
    assert_almost_eq(r2.direction, direction)


def test_batched_rays():
    r = R.ray(np.zeros((4, 3)), np.tile([0.0, 0.0, 1.0], (4, 1)), **CPU)
    assert_almost_eq(R.position(r, np.arange(4.0))[:, 2], [0, 1, 2, 3])


# --- colors (tests/test_colors.py; reference: src/color.rs:100-141) ----------

def color(r, g, b):
    return C.color(r, g, b, **CPU)


def test_colors_are_red_green_blue():
    assert_almost_eq(color(-0.5, 0.4, 1.7), [-0.5, 0.4, 1.7], eps=1e-12)


@pytest.mark.parametrize("op,expected", [
    (lambda: color(0.9, 0.6, 0.75) + color(0.7, 0.1, 0.25), [1.6, 0.7, 1.0]),
    (lambda: color(0.9, 0.6, 0.75) - color(0.7, 0.1, 0.25), [0.2, 0.5, 0.5]),
    (lambda: color(0.2, 0.3, 0.4) * 2.0, [0.4, 0.6, 0.8]),
    (lambda: color(1.0, 0.2, 0.4) * color(0.9, 1.0, 0.1), [0.9, 0.2, 0.04]),
], ids=["adding", "subtracting", "by_a_scalar", "by_a_color"])
def test_color_arithmetic(op, expected):
    assert_almost_eq(op(), expected)


# --- materials (tests/test_materials.py; reference: src/material.rs:78-215) --

WHITE = (1.0, 1.0, 1.0)
BLACK = (0.0, 0.0, 0.0)


def lighting(m: Material, light_pos, light_int, position, eyev, normalv,
             in_shadow=False, surface_color=None):
    """A scalar view of the batched Phong function."""
    row = lambda v: torch.tensor([v], dtype=F64)
    out = L.lighting(row(surface_color if surface_color is not None else m.color),
                     row(m.ambient), row(m.diffuse), row(m.specular), row(m.shininess),
                     torch.tensor(light_pos, dtype=F64), torch.tensor(light_int, dtype=F64),
                     row(position), row(eyev), row(normalv), torch.tensor([in_shadow]))
    return out.numpy()[0]


def test_the_default_material():
    m = Material()
    assert m.color == WHITE
    assert (m.ambient, m.diffuse, m.specular, m.shininess) == (0.1, 0.9, 0.9, 200.0)


def test_reflectivity_for_the_default_material():
    assert Material().reflective == 0.0


def test_transparency_and_refractive_index_for_the_default_material():
    m = Material()
    assert m.transparency == 0.0
    assert m.refractive_index == 1.0


@pytest.mark.parametrize("light,eyev,in_shadow,expected", [
    ([0, 0, -10], [0, 0, -1], False, 1.9),
    ([0, 0, -10], [0, S2 / 2, -S2 / 2], False, 1.0),
    ([0, 10, -10], [0, 0, -1], False, 0.7364),
    ([0, 10, -10], [0, -S2 / 2, -S2 / 2], False, 1.6364),
    ([0, 0, 10], [0, 0, -1], False, 0.1),
    ([0, 0, -10], [0, 0, -1], True, 0.1),
], ids=["eye_between_light_and_surface", "eye_offset_45", "light_offset_45",
        "eye_in_reflection_path", "light_behind_surface", "surface_in_shadow"])
def test_lighting(light, eyev, in_shadow, expected):
    r = lighting(Material(), light, WHITE, [0, 0, 0], eyev, [0, 0, -1], in_shadow=in_shadow)
    assert_almost_eq(r, [expected] * 3)


def test_lighting_with_a_pattern_applied():
    # the wavefront resolves the pattern before lighting: pass the color
    # the stripe gives at each point
    m = Material(ambient=1.0, diffuse=0.0, specular=0.0, pattern=stripe_pattern(WHITE, BLACK))
    c1 = lighting(m, [0, 0, -10], WHITE, [0.9, 0, 0], [0, 0, -1], [0, 0, -1],
                  surface_color=WHITE)
    c2 = lighting(m, [0, 0, -10], WHITE, [1.1, 0, 0], [0, 0, -1], [0, 0, -1],
                  surface_color=BLACK)
    assert_almost_eq(c1, [1.0, 1.0, 1.0])
    assert_almost_eq(c2, [0.0, 0.0, 0.0])


# --- patterns (tests/test_patterns.py; reference: src/pattern.rs:106-283) ----

WHITE3 = np.array(WHITE)
BLACK3 = np.array(BLACK)


def pattern_color(kind, p, a=WHITE3, b=BLACK3):
    """Pattern::color_at in pattern space (src/pattern.rs:68-95)."""
    row = lambda v: torch.tensor(np.asarray([v], dtype=np.float64))
    return P.color_at(row(p), torch.tensor([kind], dtype=torch.int32), row(a), row(b)).numpy()[0]


def color_at_shape(shape, pattern, world_point):
    """Pattern::color_at_shape through the compiled affine (src/pattern.rs:98-103)."""
    shape.material = Material(pattern=pattern)
    scene = compile_scene(World(objects=[shape]), dtype=F64, **CPU)
    pinv = scene.pat_inv[0].numpy()
    p = pinv[:, :3] @ np.asarray(world_point, dtype=np.float64) + pinv[:, 3]
    return pattern_color(int(scene.pat_kind[0]), p, scene.pat_a[0].numpy(),
                         scene.pat_b[0].numpy())


def test_creating_a_stripe_pattern():
    p = stripe_pattern(WHITE3, BLACK3)
    assert p.kind == P.STRIPE
    assert p.a == (1.0, 1.0, 1.0) and p.b == (0.0, 0.0, 0.0)


@pytest.mark.parametrize("axis", [1, 2], ids=["y", "z"])
def test_a_stripe_pattern_is_constant(axis):
    for c in (0.0, 1.0, 2.0):
        p = [0.0, 0.0, 0.0]
        p[axis] = c
        assert_almost_eq(pattern_color(P.STRIPE, p), WHITE3)


def test_a_stripe_pattern_alternates_in_x():
    for x, want in [(0.0, WHITE3), (0.9, WHITE3), (1.0, BLACK3), (-0.1, BLACK3),
                    (-1.0, BLACK3), (-1.1, WHITE3)]:
        assert_almost_eq(pattern_color(P.STRIPE, [x, 0, 0]), want)


@pytest.mark.parametrize("shape,pattern,world_point,expected", [
    (lambda: S.sphere(transform=X.scaling(2, 2, 2)), lambda: stripe_pattern(WHITE3, BLACK3),
     [1.5, 0, 0], WHITE3),
    (lambda: S.sphere(), lambda: stripe_pattern(WHITE3, BLACK3).set_transform(
        X.scaling(2, 2, 2)), [1.5, 0, 0], WHITE3),
    (lambda: S.sphere(transform=X.scaling(2, 2, 2)), lambda: stripe_pattern(
        WHITE3, BLACK3).set_transform(X.translation(0.5, 0, 0)), [2.5, 0, 0], WHITE3),
    (lambda: S.sphere(transform=X.scaling(2, 2, 2)), test_pattern, [2, 3, 4],
     [1.0, 1.5, 2.0]),
    (lambda: S.sphere(), lambda: test_pattern().set_transform(X.scaling(2, 2, 2)),
     [2, 3, 4], [1.0, 1.5, 2.0]),
    (lambda: S.sphere(transform=X.scaling(2, 2, 2)), lambda: test_pattern().set_transform(
        X.translation(0.5, 1, 1.5)), [2.5, 3, 3.5], [0.75, 0.5, 0.25]),
], ids=["stripes_object_transform", "stripes_pattern_transform", "stripes_both",
        "object_transform", "pattern_transform", "both"])
def test_a_pattern_with_transformations(shape, pattern, world_point, expected):
    assert_almost_eq(color_at_shape(shape(), pattern(), world_point), expected)


def test_the_default_pattern_transformation():
    assert_almost_eq(stripe_pattern(WHITE3, BLACK3).transform, np.eye(4))


def test_assigning_a_pattern_transformation():
    pat = test_pattern().set_transform(X.translation(1, 2, 3))
    assert_almost_eq(pat.transform, X.translation(1, 2, 3))


def test_a_gradient_linearly_interpolates_between_colors():
    for x, want in [(0, WHITE3), (0.25, [0.75] * 3), (0.5, [0.5] * 3), (0.75, [0.25] * 3)]:
        assert_almost_eq(pattern_color(P.GRADIENT, [x, 0, 0]), want)


def test_a_ring_should_extend_in_both_x_and_z():
    for p, want in [([0, 0, 0], WHITE3), ([1, 0, 0], BLACK3), ([0, 0, 1], BLACK3),
                    ([0.708, 0, 0.708], BLACK3)]:
        assert_almost_eq(pattern_color(P.RING, p), want)


@pytest.mark.parametrize("axis", [0, 1, 2], ids=["x", "y", "z"])
def test_checkers_should_repeat(axis):
    for c, want in [(0.0, WHITE3), (0.99, WHITE3), (1.01, BLACK3)]:
        p = [0.0, 0.0, 0.0]
        p[axis] = c
        assert_almost_eq(pattern_color(P.CHECKERS, p), want)


def test_none_pattern_yields_first_color():
    assert_almost_eq(pattern_color(P.NONE, [5.0, -3.0, 2.0], a=np.array([0.3, 0.4, 0.5])),
                     [0.3, 0.4, 0.5])


# --- each function against rtc_tpu's on seeded batches, at 1e-12 -------------

RNG_SEED = 12


def _inputs():
    rng = np.random.default_rng(RNG_SEED)
    a4, b4 = rng.normal(size=(2, 16, 4))
    a4[0] = 0.0  # a zero tuple: normalize gives zero
    a4[1:6, 3] = [0.0, 1.0, 0.5, 1.0, 0.0]
    m = rng.normal(size=(5, 4, 4)) + 4.0 * np.eye(4)
    return rng, a4, b4, m


def _same(got, want, eps=1e-12):
    got = [got] if not isinstance(got, tuple) else got
    want = [want] if not isinstance(want, tuple) else want
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=eps, rtol=0)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _tuples_case(name):
    rng, a, b, _ = _inputs()
    x = rng.normal(size=3)
    ta, tb = _t(a), _t(b)
    return {
        "tuple4": (lambda: T.tuple4(*a.T, **CPU), lambda: JT.tuple4(*a.T)),
        "point": (lambda: T.point(*x, **CPU), lambda: JT.point(*x)),
        "vector": (lambda: T.vector(*x, **CPU), lambda: JT.vector(*x)),
        "is_point": (lambda: T.is_point(ta), lambda: JT.is_point(a)),
        "is_vector": (lambda: T.is_vector(ta), lambda: JT.is_vector(a)),
        "magnitude": (lambda: T.magnitude(ta), lambda: JT.magnitude(a)),
        "normalize": (lambda: T.normalize(ta), lambda: JT.normalize(a)),
        "dot": (lambda: T.dot(ta, tb), lambda: JT.dot(a, b)),
        "cross": (lambda: T.cross(ta, tb), lambda: JT.cross(a, b)),
        "reflect": (lambda: T.reflect(ta, tb), lambda: JT.reflect(a, b)),
        "almost_equal": (lambda: T.almost_equal(ta, ta + 1e-6 * tb),
                         lambda: JT.almost_equal(a, a + 1e-6 * b)),
    }[name]


@pytest.mark.parametrize("name", ["tuple4", "point", "vector", "is_point", "is_vector",
                                  "magnitude", "normalize", "dot", "cross", "reflect",
                                  "almost_equal"])
def test_tuples_match_rtc_tpu(name):
    port, ref = _tuples_case(name)
    _same(port(), ref())


def _matrices_case(name):
    _, a, _, m = _inputs()
    tm, ta = _t(m), _t(a[:5])
    sing = m.copy()
    sing[2, 3] = 0.0
    return {
        "identity": (lambda: M.identity(3, **CPU), lambda: JM.identity(3)),
        "transpose": (lambda: M.transpose(tm), lambda: JM.transpose(m)),
        "matmul": (lambda: M.matmul(tm, tm.flip(0)), lambda: JM.matmul(m, m[::-1])),
        "mul_tuple": (lambda: M.mul_tuple(tm, ta), lambda: JM.mul_tuple(m, a[:5])),
        "submatrix": (lambda: M.submatrix(tm, 1, 2), lambda: JM.submatrix(m, 1, 2)),
        "determinant": (lambda: M.determinant(tm), lambda: JM.determinant(m)),
        "minor": (lambda: M.minor(tm, 3, 0), lambda: JM.minor(m, 3, 0)),
        "cofactor": (lambda: M.cofactor(tm, 2, 1), lambda: JM.cofactor(m, 2, 1)),
        "is_invertible": (lambda: M.is_invertible(_t(sing)), lambda: JM.is_invertible(sing)),
        "inverse": (lambda: M.inverse(tm), lambda: JM.inverse(m)),
        "almost_equal": (lambda: M.almost_equal(tm, tm + 1e-6 * tm.flip(0)),
                         lambda: JM.almost_equal(m, m + 1e-6 * m[::-1])),
    }[name]


@pytest.mark.parametrize("name", ["identity", "transpose", "matmul", "mul_tuple",
                                  "submatrix", "determinant", "minor", "cofactor",
                                  "is_invertible", "inverse", "almost_equal"])
def test_matrices_match_rtc_tpu(name):
    port, ref = _matrices_case(name)
    _same(port(), ref())


def test_rays_match_rtc_tpu():
    rng = np.random.default_rng(RNG_SEED)
    o, d = rng.normal(size=(2, 16, 3))
    t = rng.normal(size=16)
    m = X.translation(*rng.normal(size=3)) @ X.rotation_y(0.4) @ X.scaling(2.0, 0.5, 3.0)
    r, jr = R.ray(o, d, **CPU), JR.ray(o, d)
    _same(tuple(r), tuple(jr))
    _same(R.position(r, t), JR.position(jr, t))
    _same(tuple(R.transform(r, m)), tuple(JR.transform(jr, m)))


@pytest.mark.parametrize("name", ["color", "black", "white", "red", "green", "blue"])
def test_colors_match_rtc_tpu(name):
    if name == "color":
        c = np.random.default_rng(RNG_SEED).normal(size=(3, 7))
        _same(C.color(*c, **CPU), JC.color(*c))
    else:
        _same(getattr(C, name)(**CPU), getattr(JC, name)())


def test_vec_transforms_lighting_and_aabb_match_rtc_tpu():
    rng = np.random.default_rng(RNG_SEED)
    a, b = rng.normal(size=(2, 32, 3))
    den = rng.normal(size=32)
    den[::4] = 0.0
    ta, tb = _t(a), _t(b)
    _same(vec.dot(ta, tb), JV.dot(a, b))
    _same(vec.cross(ta, tb), JV.cross(a, b))
    _same(vec.magnitude(ta), JV.magnitude(a))
    _same(vec.reflect(ta, vec.normalize(tb)), JV.reflect(a, JV.normalize(b)))
    _same(vec.safe_div(ta[:, 0], _t(den)), JV.safe_div(a[:, 0], den))
    _same(vec.safe_div(ta[:, 0], _t(den), eps=0.5), JV.safe_div(a[:, 0], den, eps=0.5))

    m = (X.translation(*rng.normal(size=3)) @ X.rotation_x(0.3) @ X.rotation_z(-1.1)
         @ X.scaling(2.0, 0.5, 3.0))
    _same(X.affine_inverse(m), JX.affine_inverse(m))
    _same(X.transform_points(m, ta), JX.transform_points(m, a))
    _same(X.transform_dirs(m, ta), JX.transform_dirs(m, a))

    n = a.shape[0]
    color, mats = rng.uniform(size=(n, 3)), rng.uniform(0.05, 1.0, size=(4, n))
    mats[3] *= 200.0
    light_pos, light_int = rng.normal(size=3) * 10.0, rng.uniform(size=3)
    eyev = b / np.linalg.norm(b, axis=1, keepdims=True)
    normalv = rng.normal(size=(n, 3))
    normalv /= np.linalg.norm(normalv, axis=1, keepdims=True)
    shadow = rng.uniform(size=n) < 0.3
    args = (color, *mats, light_pos, light_int, a, eyev, normalv)
    _same(L.lighting(*map(_t, args), torch.from_numpy(shadow)),
          JL.lighting(*map(jnp.asarray, args), jnp.asarray(shadow)))

    lo = rng.normal(size=(n, 3)) - 1.0
    hi = lo + rng.uniform(0.1, 2.0, size=(n, 3))
    d = b.copy()
    d[::5, 1] = 0.0  # rays parallel to a slab
    _same(tuple(I.aabb(ta, _t(d), _t(lo), _t(hi))), tuple(JI.aabb(a, d, lo, hi)))
