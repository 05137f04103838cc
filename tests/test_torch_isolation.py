"""The port stands alone: no jax, nothing of lvd_tpu; entry points need the
card unless the CPU is asked for; wrappers take the plain path only for CPU
tensors, without counting a launch."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "lvd_tpu_torch"

BLOCKED_IMPORT = r"""
import importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "lvd_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import lvd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lvd_tpu_torch.__path__, "lvd_tpu_torch.")]
for name in names:
    __import__(name)
assert not any(m.split(".")[0] in ("jax", "lvd_tpu") for m in sys.modules), "leaked"
print(len(names))
"""


def test_port_imports_with_jax_and_lvd_tpu_blocked():
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _imported_modules(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_jax_nor_lvd_tpu(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in ("jax", "jaxlib", "lvd_tpu")]
    assert not bad, f"{path.name} imports {bad}"


def test_source_scan_covers_the_parallel_package():
    """The scan above reaches parallel/ (the collectives, the mesh, the
    census, the ranks) and the rank tasks of the sharded tests, which the
    ranks import without jax."""
    scanned = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"parallel/comm.py", "parallel/mesh.py", "parallel/audit.py",
            "parallel/launch.py"} <= scanned
    helper = REPO / "tests" / "_torch_parallel_ranks.py"
    bad = [m for m in _imported_modules(helper) if m.split(".")[0] in ("jax", "jaxlib", "lvd_tpu")]
    assert not bad, bad


def test_entry_points_raise_without_card(monkeypatch):
    from lvd_tpu_torch.models.loader import params_from_numpy
    from lvd_tpu_torch.pipeline import TextToVideoPipeline
    from lvd_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": [1.0]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TextToVideoPipeline(None)
    assert resolve_device("cpu").type == "cpu"


def _wrapper_calls():
    from lvd_tpu_torch.ops import conv3x3, geglu_fused, linear_fused, packed_attention
    from lvd_tpu_torch.ops import spatial_conv_fused, temp_conv_fused, temporal_attention

    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    c = 128
    lin = lambda a, b: {"w": r(a, b) * a ** -0.5, "b": r(b) * 0.1}
    attn = lambda: {"to_q": lin(c, c), "to_k": lin(c, c), "to_v": lin(c, c), "to_out": lin(c, c)}
    norm = {"scale": torch.ones(c), "bias": torch.zeros(c)}
    pair = {"norm1": norm, "attn1": attn(), "norm2": norm, "attn2": attn()}
    y = r(1, 4, 8, c)
    return {
        "attention_packed": (packed_attention.attention_packed,
                             lambda: packed_attention.attention_packed(
                                 r(1, 40, c), r(1, 77, c), r(1, 77, c), 0.125, 2)),
        "temporal_attention_pair": (temporal_attention.temporal_attention_pair,
                                    lambda: temporal_attention.temporal_attention_pair(
                                        pair, y, 2, 1e-5, frames_major=True)),
        "geglu_mlp": (geglu_fused.geglu_mlp,
                      lambda: geglu_fused.geglu_mlp(
                          {"proj": lin(c, 8 * c), "out": lin(4 * c, c)}, r(3, c))),
        # inner 4352 puts the weights past lvd_tpu's resident budget: kernel J's route.
        "geglu_stream": (geglu_fused.geglu_stream,
                         lambda: geglu_fused.geglu_mlp(
                             {"proj": lin(2 * c, 68 * c), "out": lin(34 * c, 2 * c)},
                             r(3, 2 * c))),
        "norm_silu_temporal_conv": (temp_conv_fused.norm_silu_temporal_conv,
                                    lambda: temp_conv_fused.norm_silu_temporal_conv(
                                        y, torch.ones(1, c), torch.zeros(1, c),
                                        r(3, 1, 1, c, c) * 0.05, torch.zeros(c))),
        "linear": (linear_fused.linear_rows,
                   lambda: linear_fused.linear({"w": r(c, c) * 0.1}, r(2, 5, c))),
        "norm_silu_conv2d": (spatial_conv_fused.norm_silu_conv2d,
                             lambda: spatial_conv_fused.norm_silu_conv2d(
                                 r(2, 5, 9, 16), torch.ones(2, 16), torch.zeros(2, 16),
                                 r(3, 3, 16, 8) * 0.1, torch.zeros(8))),
        "conv3x3": (conv3x3.conv3x3, lambda: conv3x3.conv3x3(r(2, 8, 8, 64), r(3, 3, 64, 64) * 0.05)),
    }


@pytest.mark.parametrize("name", ["attention_packed", "temporal_attention_pair", "geglu_mlp",
                                  "geglu_stream", "norm_silu_temporal_conv", "linear",
                                  "norm_silu_conv2d", "conv3x3"])
def test_wrapper_takes_plain_path_on_cpu_without_counting(name, monkeypatch):
    from lvd_tpu_torch.ops import _build

    def no_library():
        raise AssertionError("a CPU tensor must not reach the CUDA library")

    monkeypatch.setattr(_build, "lib", no_library)
    wrapper, call = _wrapper_calls()[name]
    before = wrapper.launches
    out = call()
    assert torch.isfinite(out).all()
    assert wrapper.launches == before == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routing_predicates_ignore_dtype(dtype):
    """The UNet's predicates do not turn fp32 away from the kernels: off the
    CPU (here the meta device) an fp32 tensor reaches a kernel wrapper, not a
    plain path, wherever lvd_tpu's predicate holds; the GEGLU and opt-in
    predicates weigh the type by its size, as lvd_tpu's do."""
    from lvd_tpu_torch.ops import geglu_fused, linear_fused, spatial_conv_fused
    from lvd_tpu_torch.ops import temp_conv_fused, temporal_attention

    y = torch.zeros(1, 24, 8, 320, dtype=dtype, device="meta")
    assert temporal_attention.supported(y, 5)
    assert temp_conv_fused.supported(y)
    x = torch.zeros(2048, 320, dtype=dtype, device="meta")
    assert geglu_fused.supported(torch.zeros(320, 2560), torch.zeros(1280, 320), x)
    # The opt-in kernels' predicates weigh the type as lvd_tpu's do, by itemsize.
    assert spatial_conv_fused.supported(torch.zeros(48, 20, 36, 640, dtype=dtype, device="meta"),
                                        torch.zeros(3, 3, 640, 640, device="meta"))
    assert linear_fused.supported(torch.zeros(640, 640, device="meta"),
                                  torch.zeros(8, 640, dtype=dtype, device="meta"))
