"""The port's copied config, codec and constant tables equal the JAX
package's, and ``tables_from_numpy`` loads the JAX arrays into an
``OrbExtractor`` exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import pislam_tpu.config as jconfig
import pislam_tpu_torch.config as tconfig
from pislam_tpu.ops import brief as jbrief
from pislam_tpu.ops import nms as jnms
from pislam_tpu.ops import orientation as jorient
from pislam_tpu.ops import patches as jpatches
from pislam_tpu.ops._brief_pattern import BRIEF_PATTERN as J_PATTERN
from pislam_tpu.utils import codec as jcodec
from pislam_tpu_torch import OrbExtractor, tables_from_numpy
from pislam_tpu_torch.ops import brief as tbrief
from pislam_tpu_torch.ops import nms as tnms
from pislam_tpu_torch.ops import orientation as torient
from pislam_tpu_torch.ops import patches as tpatches
from pislam_tpu_torch.ops._brief_pattern import BRIEF_PATTERN as T_PATTERN
from pislam_tpu_torch.utils import codec as tcodec
from torch_parity import eval_config, i64, port_config

torch.set_num_threads(1)

CLASSES = ("PyramidConfig", "FrontendConfig", "MatcherConfig", "VOConfig",
           "BAConfig", "MapConfig", "MeshConfig", "PislamConfig")
CONFIGS = (jconfig.PislamConfig(), eval_config(),
           jconfig.PislamConfig(pyramid=jconfig.PyramidConfig(96, 80, 2)))


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields(name):
    jf = dataclasses.fields(getattr(jconfig, name))
    tf = dataclasses.fields(getattr(tconfig, name))
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert a.type == b.type
        if a.default is not dataclasses.MISSING:
            assert a.default == b.default, (name, a.name)
    ja, ta = getattr(jconfig, name)(), getattr(tconfig, name)()
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)


@pytest.mark.parametrize("jcfg", CONFIGS)
def test_config_json_roundtrip(jcfg):
    tcfg = port_config(jcfg)
    assert tcfg.to_json() == jcfg.to_json()
    assert jconfig.PislamConfig.from_json(tcfg.to_json()) == jcfg
    for prop in ("level_sizes", "level_rows", "total_height", "stride",
                 "padded_height"):
        assert getattr(tcfg.pyramid, prop) == getattr(jcfg.pyramid, prop)


def test_codec_roundtrip():
    rng = np.random.default_rng(0)
    score = rng.integers(0, 256, 1000)
    x = rng.integers(0, 4096, 1000)
    y = rng.integers(0, 4096, 1000)
    enc = tcodec.encode(torch.as_tensor(score), torch.as_tensor(x), torch.as_tensor(y))
    assert np.array_equal(enc.numpy(), i64(jcodec.encode(score, x, y)))
    assert np.array_equal(tcodec.decode_score(enc).numpy(), score)
    assert np.array_equal(tcodec.decode_x(enc).numpy(), x)
    assert np.array_equal(tcodec.decode_y(enc).numpy(), y)
    bits = tcodec.u32_to_i32(enc)
    assert bits.dtype == torch.int32
    assert np.array_equal(bits.numpy().view(np.uint32), enc.numpy().astype(np.uint32))
    assert torch.equal(tcodec.i32_to_u32(bits), enc)


@pytest.mark.parametrize("name", ["pattern", "IDX0", "IDX1", "GDIFF", "gm_packed",
                                  "MOMENT_WEIGHTS", "VMAX", "disc_mask",
                                  "packed_index_map", "remap"])
def test_constant_tables(name):
    j, t = {
        "pattern": (np.array(J_PATTERN), np.array(T_PATTERN)),
        "IDX0": (jbrief.IDX0, tbrief.IDX0),
        "IDX1": (jbrief.IDX1, tbrief.IDX1),
        "GDIFF": (jbrief.GDIFF, tbrief.GDIFF),
        "gm_packed": (jbrief._gm_packed(), tbrief._gm_packed()),
        "MOMENT_WEIGHTS": (jorient.MOMENT_WEIGHTS, torient.MOMENT_WEIGHTS),
        "VMAX": (jorient.VMAX, torient.VMAX),
        "disc_mask": (jorient.disc_mask(), torient.disc_mask()),
        "packed_index_map": (jpatches.packed_index_map(), tpatches.packed_index_map()),
        "remap": (jpatches.remap_weights_packed(jbrief.GDIFF),
                  tpatches.remap_weights_packed(tbrief.GDIFF)),
    }[name]
    assert j.dtype == t.dtype and np.array_equal(j, t)


@pytest.mark.parametrize("jcfg", CONFIGS)
def test_level_mask(jcfg):
    pc, b = jcfg.pyramid, jcfg.frontend.border
    args = (pc.level_sizes, pc.level_rows, pc.padded_height, pc.stride, b)
    assert np.array_equal(jnms.make_level_mask(*args), tnms.make_level_mask(*args))


def _jax_arrays(jcfg):
    pc = jcfg.pyramid
    return {
        "IDX0": jbrief.IDX0, "IDX1": jbrief.IDX1, "GDIFF": jbrief.GDIFF,
        "gm_packed": jbrief._gm_packed(), "MOMENT_WEIGHTS": jorient.MOMENT_WEIGHTS,
        "level_mask": jnms.make_level_mask(pc.level_sizes, pc.level_rows,
                                           pc.padded_height, pc.stride,
                                           jcfg.frontend.border),
    }


@pytest.mark.parametrize("jcfg", CONFIGS)
def test_tables_from_numpy(jcfg):
    """The JAX package's arrays load into the same buffers the port builds."""
    own = OrbExtractor(port_config(jcfg))
    loaded = OrbExtractor(port_config(jcfg))
    for buf in loaded.buffers():
        buf.zero_()
    loaded.load_state_dict(tables_from_numpy(_jax_arrays(jcfg)))
    own_state, state = own.state_dict(), loaded.state_dict()
    assert own_state.keys() == state.keys() == {"level_mask", "idx0", "idx1", "mom_w"}
    for k in own_state:
        assert own_state[k].dtype == state[k].dtype
        assert torch.equal(own_state[k], state[k]), k


@pytest.mark.parametrize("bad", ["GDIFF", "gm_packed", "MOMENT_WEIGHTS"])
def test_tables_from_numpy_rejects_inconsistent_arrays(bad):
    arrays = _jax_arrays(jconfig.PislamConfig())
    arrays[bad] = arrays[bad].copy()
    arrays[bad][5, 1] += 0.5 if bad == "MOMENT_WEIGHTS" else 1
    with pytest.raises(ValueError):
        tables_from_numpy(arrays)
