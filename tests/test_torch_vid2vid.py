"""The upsample path on the CPU against lvd_tpu's: the VAE encoder,
``encode_video``, ``video_to_video``, the Zeroscope runner's XL option, the
upsample CLI, and the slice as a whole.

Both packages run the same tiny weights, fp32: lvd_tpu's tiny models
(``tiny_pipeline_models``, its preset at 64x96) as the port draws them in
lvd_tpu's key order, bridged to lvd_tpu as numpy, and the upsample CLI's
tiny SDXL refiner likewise (tests/test_torch_unet2d_sdxl.py). Each package's
pipelines are built once a module, so lvd_tpu compiles one unguided
2-step sampler for the video (shared by vid2vid, the runner's text-to-video
and the XL refine) and one for the refiner.

- the encoder's (mean, logvar) at an odd size (the asymmetric pad of its
  downsample) and ``encode_video`` at seed 3 in two chunks: 1e-4 of max;
  in a bf16 pipeline its posterior sample is lvd_tpu's bf16 draw, bit for
  bit;
- ``video_to_video(output_type="latent")``, 6 steps at strength 0.35 (two
  tail steps): 1e-4 of max;
- ``zeroscope_dpm.init("xl")`` + ``run`` under ``LVD_TINY=1``, with a
  recording upsampler in both packages: the same call (prompt, seed,
  strength 0.6), its video and the written frames within one uint8 level,
  the same files;
- ``cli.upsample.main``'s layer with recording upsamplers: file discovery
  (.joblib and .npz), the skip rule, the prompt of each index, the suffixes
  and formats of each method, the same calls in the same order;
- the uint8 repair: the port's ``upsample_video_zsxl`` on uint8 frames
  equals lvd_tpu's on the same frames as float / 255, while lvd_tpu's on
  the uint8 frames clips them to white and reads far off (the divergence,
  ROADMAP C);
- the slice as a whole: ``upsample_video_zsxl`` then ``upsample_video_sdxl``
  (4 frames, 6 steps, the refiner's tiny 64x96 target). The XL video is
  decoded through uint8 on the device by both packages, so it is held
  within one uint8 level (its latents are held at 1e-4 above); each
  refiner then runs on lvd_tpu's XL video and is held at 1e-4 of max.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lvd_tpu.cli.upsample as j_up
import lvd_tpu_torch.cli.upsample as t_up
from lvd_tpu import config as jcfg
from lvd_tpu_torch.models.loader import tiny_pipeline_models
from test_torch_unet2d_sdxl import sdxl_pipelines

TOL = 1e-4
FRAMES = 4
STEPS = 6  # strength 0.35: int(6 * 0.35) = 2 tail steps


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the whole module, its module fixtures' draws
    included (autouse fixtures of a scope are set up before the others):
    the suite runs six workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_rel(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max|d|/max|ref| = {err:.3g} > {tol}"


@pytest.fixture(scope="module")
def xl_pipes():
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


@pytest.fixture(scope="module")
def sdxl_pipes():
    return sdxl_pipelines()


def _frames(seed, hw=(32, 48)):
    return np.random.default_rng(seed).random((FRAMES, *hw, 3)).astype(np.float32)


def test_vae_encode_matches_lvd_tpu(xl_pipes):
    from lvd_tpu.models.vae import encode as j_encode
    from lvd_tpu_torch.models.vae import encode

    jpipe, pipe = xl_pipes
    x = np.random.default_rng(1).uniform(-1, 1, (2, 44, 60, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: j_encode(p, jpipe.preset.vae, x))(jpipe.vae_params, x)
    with torch.no_grad():
        got = encode(pipe.vae_params, pipe.preset.vae, torch.from_numpy(x))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape == (2, 5, 7, 4)
        _close_rel(g.numpy(), r)


def test_encode_video_matches_lvd_tpu(xl_pipes):
    jpipe, pipe = xl_pipes
    video = _frames(2, (64, 96))
    ref = jpipe.encode_video(video, seed=3, chunk=2)
    got = pipe.encode_video(video, seed=3, chunk=2)
    assert got.shape == ref.shape == (1, FRAMES, 8, 12, 4)
    _close_rel(got.numpy(), ref)
    # A second chunk takes the next key of the chain: not the first's noise.
    one = pipe.encode_video(video[:2], seed=3, chunk=2)
    np.testing.assert_array_equal(one.numpy(), got[:, :2].numpy())


def test_bf16_encode_video_draws_lvd_tpus_bf16_normal(xl_pipes, monkeypatch):
    """In a bf16 pipeline the posterior sample is lvd_tpu's bf16 draw
    (``jax.random.normal(sub, shape, bfloat16)``), bit for bit: the encoder
    is stubbed to mean 0, logvar 0 and the scaling factor set to 1 in both
    packages, so the latents are the draw itself."""
    import lvd_tpu.models.vae as j_vae
    import lvd_tpu_torch.pipeline as t_pipeline
    from lvd_tpu.pipeline import TextToVideoPipeline as JPipe
    from lvd_tpu_torch.pipeline import TextToVideoPipeline

    jpipe, pipe = xl_pipes
    lat = lambda x: (x.shape[0], x.shape[1] // 8, x.shape[2] // 8, 4)
    monkeypatch.setattr(j_vae, "encode", lambda p, cfg, x: (
        jnp.zeros(lat(x), x.dtype), jnp.zeros(lat(x), x.dtype)))
    monkeypatch.setattr(t_pipeline, "vae_encode", lambda p, cfg, x: (
        torch.zeros(lat(x), dtype=x.dtype), torch.zeros(lat(x), dtype=x.dtype)))
    video = _frames(4, (64, 96))
    j_bf16 = JPipe(jpipe.m, dtype=jnp.bfloat16)
    t_bf16 = TextToVideoPipeline(pipe.m, dtype=torch.bfloat16, device="cpu")
    for p in (j_bf16, t_bf16):  # scaling factor 1: the latents are the draw itself
        p.preset = dataclasses.replace(
            p.preset, vae=dataclasses.replace(p.preset.vae, scaling_factor=1.0))
    ref = j_bf16.encode_video(video, seed=3, chunk=2)
    got = t_bf16.encode_video(video, seed=3, chunk=2)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_video_to_video_latents_match_lvd_tpu(xl_pipes):
    jpipe, pipe = xl_pipes
    video = _frames(3, (64, 96))
    kw = dict(strength=0.35, num_inference_steps=STEPS, seed=1, output_type="latent")
    ref = jpipe.video_to_video("a bear walking", video, **kw)
    got = pipe.video_to_video("a bear walking", video, **kw)
    assert got.shape == ref.shape == (1, FRAMES, 8, 12, 4)
    _close_rel(got.numpy(), ref)
    assert len(pipe.timings["steps"]) == 2 and "encode" in pipe.timings


LAYOUT = {"Prompt": "A bear walks in a forest", "Background keyword": "forest"}


def test_zeroscope_xl_runner_matches_lvd_tpu(xl_pipes, tmp_path, monkeypatch):
    """The port's ``init("xl")`` under LVD_TINY=1 builds lvd_tpu's tiny
    models (the fixture's weights); lvd_tpu's runner gets the fixture's
    pipeline instead of compiling its tiny init."""
    import importlib

    import joblib

    jpipe, _ = xl_pipes
    monkeypatch.setenv("LVD_TINY", "1")
    monkeypatch.setenv("LVD_PLATFORM", "cpu")
    calls = {}
    for package in ("lvd_tpu", "lvd_tpu_torch"):
        base = importlib.import_module(f"{package}.runners.base")
        runner = importlib.import_module(f"{package}.runners.zeroscope_dpm")
        up = importlib.import_module(f"{package}.cli.upsample")
        if package == "lvd_tpu":
            def init_pipeline(name, base=base):
                assert name == "zeroscope"
                state = base.RunnerState()
                state.pipe, state.H, state.W = jpipe, jpipe.preset.height, jpipe.preset.width
                return state
            monkeypatch.setattr(base, "init_pipeline", init_pipeline)
        record = calls.setdefault(package, [])

        def upsample(video, prompt, seed=0, strength=0.35, record=record):
            record.append((np.asarray(video), prompt, seed, strength))
            return np.asarray(video)[:, ::2, ::2]

        monkeypatch.setattr(up, "upsample_video_zsxl", upsample)
        assert runner.init("xl") == (64, 96)
        out = tmp_path / package
        monkeypatch.setattr(base, "img_dir", str(out))
        runner.run(LAYOUT, seed=0, num_inference_steps=2, num_frames=FRAMES)
        runner.run(LAYOUT, seed=0, num_inference_steps=2, num_frames=FRAMES)  # exists: skipped
        assert sorted(os.listdir(out)) == ["video_seed0.gif", "video_seed0.joblib"]
    (ref,), (got,) = calls["lvd_tpu"], calls["lvd_tpu_torch"]
    assert got[1:] == ref[1:] == ("A bear walks in a forest, forest background", 0, 0.6)
    # The decoded video, uint8 / 255 on both sides: within one uint8 level.
    assert got[0].shape == ref[0].shape and np.abs(got[0] - ref[0]).max() <= 1 / 255 + 1e-6
    frames = [joblib.load(tmp_path / p / "video_seed0.joblib") for p in ("lvd_tpu_torch", "lvd_tpu")]
    assert frames[0].shape == frames[1].shape == (FRAMES, 32, 48, 3)
    assert np.abs(frames[0].astype(int) - frames[1].astype(int)).max() <= 1


def _run_dir(root):
    """Index 0: .joblib; index 1: .npz; index 2: .joblib whose zsxl output
    exists (its GIF), so --method zsxl skips it."""
    from lvd_tpu_torch.utils import vis

    rng = np.random.default_rng(6)
    video = lambda: rng.integers(0, 256, (FRAMES, 16, 24, 3), dtype=np.uint8)
    vis.save_frames(str(root / "0" / "video_0"), video(), formats=["joblib"])
    vis.save_frames(str(root / "1" / "video_1"), video(), formats=["npz"])
    vis.save_frames(str(root / "2" / "video_2"), video(), formats=["joblib"])
    vis.save_frames(str(root / "2" / "video_2_zsxl"), video(), formats=["gif"])


@pytest.mark.parametrize("method", ["zsxl", "sdxl", "zsxl+sdxl"])
def test_upsample_cli_layer_matches_lvd_tpu(method, tmp_path, monkeypatch):
    import importlib

    monkeypatch.setenv("LVD_PLATFORM", "cpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    calls, written = {}, {}
    for package in ("lvd_tpu", "lvd_tpu_torch"):
        up = importlib.import_module(f"{package}.cli.upsample")
        record = calls.setdefault(package, [])

        def recorder(name, record=record):
            def call(video, prompt, strength=0.35, num_inference_steps=50, seed=0):
                video = np.asarray(video)
                record.append((name, prompt, strength, num_inference_steps, seed, video.shape,
                               str(video.dtype), float(video.astype(np.float64).sum())))
                return np.full((len(video), 8, 12, 3), 0.25 if name == "zsxl" else 0.75,
                               np.float32)
            return call

        monkeypatch.setattr(up, "upsample_video_zsxl", recorder("zsxl"))
        monkeypatch.setattr(up, "upsample_video_sdxl", recorder("sdxl"))
        root = tmp_path / package
        _run_dir(root)
        up.main(["--run-dir", str(root), "--method", method, "--strength", "0.5",
                 "--num_inference_steps", "7", "--prompt-type", "demo", "--seed", "4",
                 "--save-formats", "gif", "npz"])
        written[package] = sorted(os.path.relpath(os.path.join(d, f), root)
                                  for d, _, fs in os.walk(root) for f in fs)
    assert calls["lvd_tpu_torch"] == calls["lvd_tpu"] and calls["lvd_tpu"]
    assert written["lvd_tpu_torch"] == written["lvd_tpu"]
    suffix = method.replace("+", "_")
    assert f"0/video_0_{suffix}.npz" in written["lvd_tpu"]
    assert f"1/video_1_{suffix}.gif" in written["lvd_tpu"]
    assert (f"2/video_2_{suffix}.npz" in written["lvd_tpu"]) == (method != "zsxl")


@pytest.fixture(scope="module")
def slice_outputs(xl_pipes, sdxl_pipes):
    """Both packages' upsample_video_zsxl and then upsample_video_sdxl under
    LVD_TINY=1 on the same float frames (uint8 / 255), each module's pipes
    set to the fixtures'; the port's zsxl also on the uint8 frames, and
    lvd_tpu's too (the defect)."""
    saved = {k: os.environ.get(k) for k in ("LVD_TINY", "LVD_PLATFORM")}
    os.environ.update(LVD_TINY="1", LVD_PLATFORM="cpu")
    try:
        for mod, xl, sd in ((j_up, xl_pipes[0], sdxl_pipes[0]),
                            (t_up, xl_pipes[1], sdxl_pipes[1])):
            mod._xl_pipe, mod._sdxl_pipe = xl, sd
        u8 = np.random.default_rng(8).integers(0, 256, (FRAMES, 32, 48, 3), dtype=np.uint8)
        frames = u8.astype(np.float32) / 255.0
        kw = dict(strength=0.35, num_inference_steps=STEPS, seed=5)
        out = {}
        for name, mod in (("lvd_tpu", j_up), ("port", t_up)):
            out[name, "zsxl"] = mod.upsample_video_zsxl(frames, "a bear walking", **kw)
        # Each refiner on the same input: lvd_tpu's XL output.
        for name, mod in (("lvd_tpu", j_up), ("port", t_up)):
            out[name, "sdxl"] = mod.upsample_video_sdxl(out["lvd_tpu", "zsxl"], "a bear walking",
                                                        **kw)
        out["port", "zsxl_u8"] = t_up.upsample_video_zsxl(u8, "a bear walking", **kw)
        out["lvd_tpu", "zsxl_u8"] = j_up.upsample_video_zsxl(u8, "a bear walking", **kw)
        return out
    finally:
        for mod in (j_up, t_up):
            mod._xl_pipe = mod._sdxl_pipe = None
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _within_one_level(got, ref):
    """The XL refine's video is decoded to uint8 on the device and divided by
    255 (as lvd_tpu's): within one uint8 level, and off by one level at
    under 1% of the values (rounding near a half level)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert got.shape == ref.shape and d.max() <= 1 / 255 + 1e-6 and (d > 1e-6).mean() < 0.01


def test_uint8_frames_are_scaled(slice_outputs):
    ref = slice_outputs["lvd_tpu", "zsxl"]  # lvd_tpu on the frames as float / 255
    np.testing.assert_array_equal(slice_outputs["port", "zsxl_u8"], slice_outputs["port", "zsxl"])
    _within_one_level(slice_outputs["port", "zsxl_u8"], ref)
    # lvd_tpu's zsxl clips the uint8 values to [0, 1]: another video.
    assert np.abs(slice_outputs["lvd_tpu", "zsxl_u8"] - ref).max() > 0.05


def test_upsample_slice_matches_lvd_tpu(slice_outputs):
    got, ref = slice_outputs["port", "zsxl"], slice_outputs["lvd_tpu", "zsxl"]
    assert got.shape == (FRAMES, 64, 96, 3) and np.isfinite(got).all()
    _within_one_level(got, ref)
    got, ref = slice_outputs["port", "sdxl"], slice_outputs["lvd_tpu", "sdxl"]
    assert got.shape == ref.shape == (FRAMES, 64, 96, 3) and np.isfinite(got).all()
    _close_rel(got, ref)
