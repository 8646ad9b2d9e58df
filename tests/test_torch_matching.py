"""K5 and the matcher: the port's ``matching`` and K5's plain version
(``kernels.match_reduce_plain``) against the JAX package, tolerance 0.

- ``match_reduce_plain`` against ``pk.match_reduce`` in Mosaic interpret
  mode, ungated and gated, with the duplicate, cross-tile and on-the-radius
  cases of tests/test_pallas_kernels.py (smaller database tiles, so the
  interpreter stays quick); tests/test_torch_kernel_plans.py holds the
  Hopper kernel's own reductions, modelled in numpy, to it;
- ``match``, ``match_gated``, ``match_many`` and ``match_features`` against
  the JAX functions on the CPU, on random words and on real features.

Descriptors use all 32 bits of every word.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import pislam_tpu_torch
from pislam_tpu import matching as jm
from pislam_tpu.ops import pallas_kernels as pk
from pislam_tpu_torch import matching as tm
from pislam_tpu_torch.ops import kernels
from pislam_tpu_torch.ops.pyramid import build_pyramid
from torch_parity import eval_config, eval_frames, jax_build_pyramid, jax_extract_fn, port_config, t

torch.set_num_threads(1)


def words(rng, k, w=8):
    return rng.integers(0, 2**32, (k, w), dtype=np.uint32)


def tw(d):
    """uint32 words -> the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(d).view(np.int32))


def reduce_case(seed, k1, k2, tile=None, gated=False):
    """Random words with exact duplicates (within and across ``tile``-column
    database tiles), invalid rows and columns, and for the gate inf / 1e6
    coordinates and a pair exactly on the radius 0.06."""
    rng = np.random.default_rng(seed)
    d1, d2 = words(rng, k1), words(rng, k2)
    tile = tile or k2
    d2[10] = d1[3]
    d2[min(tile + 7, k2 - 1)] = d1[3]            # duplicate in a later tile
    d2[min(2 * tile + 5, k2 - 1)] = d1[5]        # beats an earlier, worse one
    d2[40] = d1[5] ^ np.uint32(3)
    d2[50] = d1[9]
    d2[51] = d1[9]                                # duplicate within a tile
    d1[200 % k1] = d1[7]                          # duplicate query rows
    v1 = rng.random(k1) < 0.9
    v2 = rng.random(k2) < 0.9
    v1[[3, 5, 9]] = True
    v2[[10, min(tile + 7, k2 - 1), min(2 * tile + 5, k2 - 1), 40, 50, 51]] = True
    case = {"d1": d1, "d2": d2, "v1": v1, "v2": v2}
    if gated:
        uv1 = rng.uniform(-0.1, 0.1, (k1, 2)).astype(np.float32)
        uv2 = rng.uniform(-0.1, 0.1, (k2, 2)).astype(np.float32)
        uv2[10] = uv1[3] + [0.2, 0.0]            # perfect match, outside the gate
        uv2[20] = 1e6                             # behind-camera sentinel
        uv2[21] = np.inf
        uv1[11] = np.inf
        uv1[100 % k1] = uv2[100 % k2] + [0.06, 0.0]   # exactly on the radius
        case.update(uv1=uv1, uv2=uv2, radius=0.06)
    return case


def jax_reduce(c, **blocks):
    a, b = jm.expand_pm1(jnp.asarray(c["d1"])), jm.expand_pm1(jnp.asarray(c["d2"]))
    gate = ()
    if "radius" in c:
        gate = (jnp.asarray(c["uv1"]), jnp.asarray(c["uv2"]), c["radius"])
    with pltpu.force_tpu_interpret_mode():
        out = pk.match_reduce(a, b, jnp.asarray(c["v1"]), jnp.asarray(c["v2"]), *gate,
                              **blocks)
    return [np.asarray(o) for o in out]


def port_args(c):
    args = (tw(c["d1"]), tw(c["d2"]), t(c["v1"]), t(c["v2"]))
    if "radius" in c:
        args += (t(c["uv1"]), t(c["uv2"]), c["radius"])
    return args


def assert_reduce_equal(got, want):
    for name, g, w in zip(("best", "second", "idx", "col_argmin"), got, want):
        assert g.dtype == torch.int32, name
        assert np.array_equal(g.numpy(), w), name


@pytest.mark.parametrize("gated", [False, True])
def test_match_reduce_plain_vs_pallas(gated):
    """K1 = 320 is no multiple of the TPU's 256-row block."""
    c = reduce_case(11 + gated, 320, 256, gated=gated)
    assert_reduce_equal(kernels.match_reduce_plain(*port_args(c)), jax_reduce(c))


@pytest.mark.parametrize("gated", [False, True])
def test_match_reduce_plain_vs_pallas_tiled(gated):
    """Three 128-column database tiles and a padded tail: ties split across
    tiles go through the TPU's running merge."""
    c = reduce_case(13 + gated, 200, 128 * 2 + 64, tile=128, gated=gated)
    got = kernels.match_reduce_plain(*port_args(c))
    assert_reduce_equal(got, jax_reduce(c, block=256, block_k2=128))
    if not gated:
        assert int(got[1][3]) == int(got[0][3]) == 0  # a duplicate best is second


def test_match_reduce_all_invalid_column_and_row():
    """An all-invalid row keeps (MAX, MAX, 0); an all-invalid column's first
    argmin is row 0, as jnp.argmin gives."""
    c = reduce_case(17, 64, 96)
    c["v1"][:] = False
    c["v1"][5] = True
    c["v2"][7] = False
    best, second, idx, col = kernels.match_reduce_plain(*port_args(c))
    assert int(best[0]) == int(second[0]) == tm.MAX_DIST and int(idx[0]) == 0
    assert int(col[7]) == 0
    assert_reduce_equal((best, second, idx, col), jax_reduce(c))


def test_expand_and_hamming_matrix():
    rng = np.random.default_rng(2)
    d1, d2 = words(rng, 40), words(rng, 50)
    v1, v2 = rng.random(40) < 0.8, rng.random(50) < 0.8
    assert np.array_equal(tm.expand_pm1(tw(d1)).numpy(),
                          np.asarray(jm.expand_pm1(jnp.asarray(d1))))
    got = tm.hamming_matrix(tw(d1), tw(d2), t(v1), t(v2))
    want = jm.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
                             jnp.asarray(v2))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


def correlated_case(seed, k1, k2, w=8):
    """A database holding jittered copies of query rows, so that the
    distance, ratio and cross-check filters all bite."""
    rng = np.random.default_rng(seed)
    d1, d2 = words(rng, k1, w), words(rng, k2, w)
    for i in range(0, k1, 3):
        d2[(i * 7) % k2] = d1[i] ^ rng.integers(0, 2**10, w, dtype=np.uint32)
    d2[5] = d2[(3 * 7) % k2]                      # a tie for query row 3
    return d1, d2, rng.random(k1) < 0.95, rng.random(k2) < 0.95


@pytest.mark.parametrize("max_distance,ratio,cross_check,w",
                         [(64, 0.8, True, 8), (64, 0.85, True, 8), (48, 0.7, False, 8),
                          (30, 0.9, True, 4)])
def test_match_vs_jax(max_distance, ratio, cross_check, w):
    d1, d2, v1, v2 = correlated_case(max_distance, 200, 300, w)
    kw = dict(max_distance=max_distance, ratio=ratio, cross_check=cross_check)
    gi, gd = tm.match(tw(d1), tw(d2), t(v1), t(v2), **kw)
    wi, wd = jm.match(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2), **kw)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gd.numpy(), np.asarray(wd))
    assert (gi >= 0).sum() > 20


@pytest.mark.parametrize("radius", [0.06, 0.25])
def test_match_gated_vs_jax(radius):
    d1, d2, v1, v2 = correlated_case(5, 256, 512)
    rng = np.random.default_rng(6)
    uv1 = rng.uniform(-0.5, 0.5, (256, 2)).astype(np.float32)
    uv2 = rng.uniform(-0.5, 0.5, (512, 2)).astype(np.float32)
    for i in range(0, 256, 3):
        uv2[(i * 7) % 512] = uv1[i] + rng.uniform(-0.05, 0.05, 2).astype(np.float32)
    uv2[40], uv2[41] = 1e6, np.inf
    uv1[100] = uv2[100] + [radius, 0.0]
    kw = dict(max_distance=64, ratio=0.8, cross_check=True)
    gi, gd = tm.match_gated(tw(d1), tw(d2), t(v1), t(v2), t(uv1), t(uv2), radius, **kw)
    wi, wd = jm.match_gated(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
                            jnp.asarray(v2), jnp.asarray(uv1), jnp.asarray(uv2), radius, **kw)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gd.numpy(), np.asarray(wd))
    assert (gi >= 0).sum() > 10


@pytest.mark.parametrize("cross_check", [True, False])
def test_match_many_vs_jax(cross_check):
    rng = np.random.default_rng(8)
    descs = np.stack([correlated_case(s, 64, 96)[0] for s in range(3)])
    valids = rng.random((3, 64)) < 0.9
    _, d2, _, v2 = correlated_case(0, 64, 96)
    kw = dict(max_distance=64, ratio=0.8, cross_check=cross_check)
    gi, gc = tm.match_many(tw(descs.reshape(-1, 8)).reshape(3, 64, 8), t(valids),
                           tw(d2), t(v2), **kw)
    wi, wc = jm.match_many(jnp.asarray(descs), jnp.asarray(valids), jnp.asarray(d2),
                           jnp.asarray(v2), **kw)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gc.numpy(), np.asarray(wc)) and gc.dtype == torch.int32
    assert int(gc[0]) > 10


@pytest.mark.parametrize("pair", [(0, 1), (20, 21)])
def test_match_features_on_eval_frames(pair):
    """Real features of consecutive committed frames at the eval config."""
    jcfg = eval_config()
    tcfg = port_config(jcfg)
    feats = []
    for i in pair:
        frame = eval_frames()[i]
        jf = jax_extract_fn(jcfg)(jax_build_pyramid(jnp.asarray(frame), jcfg.pyramid))
        tf = pislam_tpu_torch.make_extract_fn(tcfg, device="cpu")(
            build_pyramid(t(frame), tcfg.pyramid))
        feats.append((jf, tf))
    (j1, t1), (j2, t2) = feats
    gi, gd = tm.match_features(t1, t2, tcfg)
    wi, wd = jm.match_features(j1, j2, jcfg)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gd.numpy(), np.asarray(wd))
    assert int((gi >= 0).sum()) > 200


def test_match_plain_reduce_is_the_default_on_cpu():
    d1, d2, v1, v2 = correlated_case(3, 100, 120)
    a = tm.match(tw(d1), tw(d2), t(v1), t(v2))
    b = tm.match(tw(d1), tw(d2), t(v1), t(v2), reduce=kernels.match_reduce_plain)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
