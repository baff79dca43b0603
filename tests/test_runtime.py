"""The GPU bring-up surface: flax-free pytree dataclasses, exact measurement
contractions, compile-cache placement, device selection and imports."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.core.config import LidarConfig, RaycastConfig, beam_bin_stride
from slam_tpu.core.types import Pose
from slam_tpu.models import fake_lidar, mcl as mcl_mod
from slam_tpu.models.simulate import synthetic_room
from slam_tpu.ops import cddt, measurement, rayfield
from slam_tpu.utils import runtime

REPO = pathlib.Path(__file__).resolve().parents[1]


def _pose():
    return Pose.create(1.0, 2.0, 0.5)


def _mcl_state():
    return mcl_mod.init(jax.random.key(0), 4, _pose())


def _ray_field():
    return rayfield.RayField(
        blocked=jnp.zeros((4, 4), bool), lut=jnp.zeros((4, 4, 8)), lut_bins=6
    )


def _cddt():
    return cddt.CDDTTable(
        starts=jnp.zeros((2, 3, 1), jnp.int16),
        ends=jnp.zeros((2, 3, 1), jnp.int16),
        n_bins=4,
        n_overflow=1,
    )


# (factory, static field -> value): static fields live in the treedef.
STRUCTS = {
    "Pose": (_pose, {}),
    "MCLState": (_mcl_state, {}),
    "RayField": (_ray_field, {"lut_bins": 6}),
    "CDDTTable": (_cddt, {"n_bins": 4, "n_overflow": 1}),
}


@pytest.mark.parametrize("name", sorted(STRUCTS))
def test_struct_flatten_unflatten(name):
    make, static = STRUCTS[name]
    obj = make()
    leaves, treedef = jax.tree.flatten(obj)
    assert all(hasattr(leaf, "dtype") for leaf in leaves)
    for field, value in static.items():
        assert value in treedef.node_data()[1]
        assert not any(leaf is value for leaf in leaves)
    back = jax.tree.unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for field, value in static.items():
        assert getattr(back, field) == value
    for a, b in zip(leaves, jax.tree.leaves(back)):
        assert a is b


@pytest.mark.parametrize("name", sorted(STRUCTS))
def test_struct_replace_and_jit(name):
    make, static = STRUCTS[name]
    obj = make()
    with pytest.raises(AttributeError):  # frozen
        setattr(obj, next(iter(obj.__dataclass_fields__)), None)
    field = next(
        f for f in obj.__dataclass_fields__ if f not in static
    )
    new = obj.replace(**{field: jax.tree.map(lambda a: a + 1, getattr(obj, field))})
    assert new is not obj

    def double(a):  # PRNG keys pass through
        return a * 2 if jnp.issubdtype(a.dtype, jnp.number) else a

    doubled = jax.jit(lambda t: jax.tree.map(double, t))(obj)
    assert type(doubled) is type(obj)
    for f, value in static.items():
        assert getattr(doubled, f) == value
    for a, b in zip(jax.tree.leaves(obj), jax.tree.leaves(doubled)):
        if jnp.issubdtype(a.dtype, jnp.number):
            np.testing.assert_array_equal(np.asarray(a) * 2, np.asarray(b))


def _dot_generals(fn, *args):
    """(operand element types, precision) of every dot_general lowered."""
    text = jax.jit(fn).lower(*args).as_text()
    out = []
    for line in text.splitlines():
        if "dot_general" not in line:
            continue
        prec = re.search(r"precision = \[([A-Z_, ]+)\]", line)
        types = re.findall(r"tensor<[^>]*x(\w+)>", line.split(":")[-1])
        out.append((types, prec.group(1) if prec else "DEFAULT"))
    return out


def _scene():
    blocked = jnp.asarray(synthetic_room(48, 48))
    lidar = LidarConfig(start=0.0, stop=np.pi, n_rays=12, max_dist=30.0)
    rc = RaycastConfig(step=0.5, max_dist=30.0, backend="lut", lut_bins=24)
    scan = fake_lidar.scan(
        blocked, Pose.create(24.0, 24.0, 0.3), lidar,
        RaycastConfig(max_dist=30.0),
    )
    poses = Pose.create(jnp.full((8,), 24.0), jnp.full((8,), 20.0),
                        jnp.linspace(-3.0, 3.0, 8))
    return blocked, lidar, rc, scan, poses


def _score_table_site():
    blocked, _, rc, scan, _ = _scene()
    from slam_tpu.ops import edt as edtlib

    edt = edtlib.edt_capped(blocked, 12.0)
    heads = jnp.linspace(-0.2, 0.2, 4)
    return (
        lambda e, z, hd: measurement.lf_score_table(
            e, z, hd, rc=rc, stddev=3.0, z_hit=0.95, z_rand=0.05,
            dtype="f32", origin=(jnp.int32(4), jnp.int32(4)),
            out_shape=(16, 16),
        ),
        (edt, scan, heads),
    )


def _fused_site(lut_dtype):
    blocked, lidar, rc, scan, poses = _scene()
    field = rayfield.make_ray_field(blocked, rc)
    field = field.replace(lut=field.lut.astype(lut_dtype))
    stride = beam_bin_stride(lidar, rc)
    return (
        lambda f, p, z: measurement.particle_log_weights(
            f, p, z, rc=rc, lut_beam_stride=stride
        ),
        (field, poses, scan),
    )


SITES = {
    "score_table_window_sum": _score_table_site,
    "fused_comb_select_f32_lut": lambda: _fused_site(jnp.float32),
    "fused_range_alignment": lambda: _fused_site(jnp.bfloat16),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_measurement_contractions_not_default_precision(site):
    """An f32 dot_general at DEFAULT precision may run in TF32 on a GPU
    (about 3 decimal digits): the score-table window sum, the fused comb
    select over an f32 table and the fused range alignment must not lower
    to one."""
    fn, args = SITES[site]()
    for types, prec in _dot_generals(fn, *args):
        if "f32" in types:
            assert "DEFAULT" not in prec, (site, types, prec)


@pytest.mark.parametrize("env", [None, "elsewhere"])
def test_compile_cache_dir_placement(monkeypatch, tmp_path, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert runtime.compile_cache_dir() == str(REPO / ".jax_cache")
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    else:
        path = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
        assert runtime.compile_cache_dir() == path


def test_compile_cache_off_on_cpu():
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_require_gpu_refuses_cpu_and_names_device():
    with pytest.raises(SystemExit) as exc:
        runtime.require_gpu(allow_cpu=False)
    assert exc.value.code not in (0, None)
    info = runtime.require_gpu(allow_cpu=True)
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def test_no_flax_or_tpu_pallas_imports():
    files = [REPO / "bench.py", REPO / "chip_smoke.py"]
    for sub in ("slam_tpu", "benchmarks"):
        files += sorted((REPO / sub).rglob("*.py"))
    bad = re.compile(
        r"^\s*(from|import)\s+(flax\b|jax\.experimental\.pallas\.tpu\b"
        r"|jax\.experimental\.pallas\s+import\s+tpu\b)",
        re.M,
    )
    hits = [str(f) for f in files if bad.search(f.read_text())]
    assert not hits, hits
