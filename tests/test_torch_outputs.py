"""The port's outputs against lvd_tpu's on the CPU: the pipeline's
``output_type="uint8_device"`` (ROADMAP C8) and the native GIF encoder
(utils/native.py).

- ``"uint8_device"``: both packages' tiny pipelines (2 frames, 2 steps,
  seed 0, "a cat", fp32) return uint8 (B*F, H, W, 3) frames on the
  pipeline's device, the port's within one uint8 level of lvd_tpu's; the
  call never waits for the device (``sync`` is not reached) and records no
  step seconds; the frames / 255 are exactly the default output, and
  decoding the ``"latent"`` output gives them again;
- the GIF encoder: the port's bytes equal lvd_tpu's native encoder's on the
  same frames (several sizes, frame rates, with and without dithering),
  ``vis.save_gif`` writes them, ``LVD_DISABLE_NATIVE=1`` writes lvd_tpu's
  PIL bytes instead, and a failed build raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvd_tpu import config as jcfg
from lvd_tpu_torch.models.loader import tiny_pipeline_models
from lvd_tpu_torch.utils import native as tnative
from lvd_tpu_torch.utils import vis as tvis

CALL = dict(prompt="a cat", num_frames=2, num_inference_steps=2, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pipes():
    """(lvd_tpu's tiny TextToVideoPipeline, the port's), fp32, on the port's
    draw of lvd_tpu's tiny models."""
    from lvd_tpu.pipeline import PipelineModels as JModels
    from lvd_tpu.pipeline import TextToVideoPipeline as JPipe
    from lvd_tpu.text.tokenizer import load_tokenizer as jtokenizer
    from lvd_tpu_torch.pipeline import TextToVideoPipeline

    models = tiny_pipeline_models(device="cpu")
    np_tree = lambda t: jax.tree_util.tree_map(lambda v: v.numpy(), t)
    p = models.preset
    jpreset = jcfg.ModelPreset(
        name="tiny", unet=jcfg.tiny_unet_config(), clip=jcfg.tiny_clip_config(),
        vae=jcfg.tiny_vae_config(), scheduler=jcfg.SchedulerConfig(), height=p.height,
        width=p.width, default_num_frames=p.default_num_frames, base_attn_dim=p.base_attn_dim)
    assert dataclasses.asdict(jpreset) == dataclasses.asdict(p)
    jpipe = JPipe(JModels(jpreset, np_tree(models.unet_params), np_tree(models.clip_params),
                          np_tree(models.vae_params), jtokenizer(None)), dtype=jnp.float32)
    return jpipe, TextToVideoPipeline(models, dtype=torch.float32, device="cpu")


def test_uint8_device_output_matches_lvd_tpu(pipes, monkeypatch):
    import lvd_tpu_torch.pipeline as tpipe

    jpipe, pipe = pipes
    ref = jpipe(**CALL, output_type="uint8_device")
    assert isinstance(ref, jax.Array)

    def no_sync(device):
        raise AssertionError("the uint8_device branch waited for the device")

    with monkeypatch.context() as m:
        m.setattr(tpipe, "sync", no_sync)
        got = pipe(**CALL, output_type="uint8_device")
    assert got.dtype == torch.uint8 and got.device == pipe.device
    assert tuple(got.shape) == ref.shape == (2, 64, 96, 3)
    assert np.abs(got.numpy().astype(np.int16) - np.asarray(ref).astype(np.int16)).max() <= 1
    assert pipe.timings["steps"] == [] and pipe.timings["guided"] == []

    video = pipe(**CALL)
    assert video.dtype == np.float32 and video.shape == (1, 2, 64, 96, 3)
    np.testing.assert_array_equal(got.numpy().astype(np.float32) / 255.0, video[0])
    assert len(pipe.timings["steps"]) == 2
    latents = pipe(**CALL, output_type="latent")
    assert tuple(latents.shape) == (1, 2, 8, 12, 4)
    assert torch.equal(pipe.decode_uint8(latents[0]), got)


@pytest.fixture
def lvd_tpu_encoder(tmp_path, monkeypatch):
    """lvd_tpu's native encoder, built by its own ``make`` into a copy of
    native/ (no other process of the suite writes there)."""
    import pathlib
    import shutil

    from lvd_tpu.utils import native as jnative

    src = pathlib.Path(jnative._NATIVE_DIR)
    copy = tmp_path / "native"
    copy.mkdir()
    for name in ("Makefile", "gifenc.cc"):
        shutil.copy(src / name, copy / name)
    monkeypatch.setattr(jnative, "_NATIVE_DIR", str(copy))
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    monkeypatch.delenv("LVD_DISABLE_NATIVE", raising=False)
    return jnative


@pytest.mark.parametrize("shape,fps,dither", [
    ((4, 64, 96, 3), 8, True), ((3, 37, 53, 3), 8, False), ((1, 16, 16, 3), 5, True),
    ((6, 40, 72, 3), 12, True)])
def test_native_gif_bytes_are_lvd_tpus(shape, fps, dither, tmp_path, lvd_tpu_encoder):
    jnative = lvd_tpu_encoder
    rng = np.random.default_rng(sum(shape))
    frames = (rng.random(shape) * 255).astype(np.uint8)
    frames[:, : shape[1] // 2] //= 3  # flat regions as well as noise
    assert jnative.gif_encode(str(tmp_path / "ref.gif"), frames, fps=fps, dither=dither)
    assert tnative.gif_encode(str(tmp_path / "got.gif"), frames, fps=fps, dither=dither)
    assert (tmp_path / "got.gif").read_bytes() == (tmp_path / "ref.gif").read_bytes()


def test_save_gif_takes_the_encoder_and_the_switch_selects_pil(tmp_path, monkeypatch,
                                                              lvd_tpu_encoder):
    from lvd_tpu.utils import vis as jvis

    jnative = lvd_tpu_encoder
    frames = (np.random.default_rng(3).random((3, 32, 48, 3)) * 255).astype(np.uint8)
    tvis.save_gif(str(tmp_path / "got.gif"), frames)
    jvis.save_gif(str(tmp_path / "ref.gif"), frames)
    assert (tmp_path / "got.gif").read_bytes() == (tmp_path / "ref.gif").read_bytes()
    # LVD_DISABLE_NATIVE=1, read at the first use: PIL, as lvd_tpu writes without its encoder
    monkeypatch.setattr(tnative, "_STATE", {})
    monkeypatch.setenv("LVD_DISABLE_NATIVE", "1")
    monkeypatch.setattr(jnative, "gif_encode", lambda *a, **k: False)
    tvis.save_gif(str(tmp_path / "got_pil.gif"), frames)
    jvis.save_gif(str(tmp_path / "ref_pil.gif"), frames)
    assert (tmp_path / "got_pil.gif").read_bytes() == (tmp_path / "ref_pil.gif").read_bytes()
    assert (tmp_path / "got_pil.gif").read_bytes() != (tmp_path / "got.gif").read_bytes()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(tnative, "_STATE", {})
    monkeypatch.delenv("LVD_DISABLE_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="broken.cc"):
        tnative.gif_encode(str(tmp_path / "x.gif"), np.zeros((1, 8, 8, 3), np.uint8))
