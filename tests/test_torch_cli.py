"""The port's CLIs: their layer against lvd_tpu's with no model, and the
port's ``generate`` end to end on the CPU with lvd_tpu's tiny models.

The CLI layer: each package's ``main(argv)`` runs in-process in a directory
of its own. For ``generate``, ``resolve_runner`` returns a recorder, so the
sequence of runner calls (parsed layout, seed, repeat index, the run
keywords, the output directory), the save dir and stdout must be equal;
``prompt_batch``, ``eval_stage_one`` and ``eval_owl_vit`` (one fake judge
injected into both) must write the same files and print the same text.
GIFs are compared on the PIL path of both packages (their native encoders
turned off; tests/test_torch_outputs.py holds the encoders' bytes equal).

End to end: ``LVD_TINY=1 LVD_PLATFORM=cpu python -m
lvd_tpu_torch.cli.generate`` with the run models and flags of
tests/test_cli_integration.py writes the files that test checks for
lvd_tpu, one run in a process where jax, jaxlib and lvd_tpu cannot be
imported. No lvd_tpu sampler runs here: the whole chain's parity follows
from the init order (test_torch_prng_init.py), the runners on shared
weights (test_torch_runners.py) and this CLI layer.
"""

import contextlib
import importlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image, ImageSequence

from test_torch_text_eval import SAMPLE_RESPONSE, _random_responses

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ("lvd_tpu", "lvd_tpu_torch")
DEMO_PROMPT = "A bear walks from the left to the right"
BEAR = ("Reasoning: the bear walks right.\n" + "\n".join(
    f"Frame {i + 1}: [{{'id': 0, 'name': 'bear', 'box': [{20 + 70 * i}, 250, 140, 160]}}]"
    for i in range(6)) + "\nBackground keyword: forest")


@pytest.fixture(autouse=True)
def quiet_lvd_tpu(monkeypatch):
    """lvd_tpu's CLIs leave the process's JAX compile cache alone
    (LVD_NO_COMPILE_CACHE), and both packages write GIFs with PIL."""
    from lvd_tpu.utils import native
    from lvd_tpu_torch.utils import native as port_native

    monkeypatch.setenv("LVD_NO_COMPILE_CACHE", "1")
    monkeypatch.delenv("LVD_PLATFORM", raising=False)
    monkeypatch.setattr(native, "gif_encode", lambda *a, **k: False)
    monkeypatch.setattr(port_native, "gif_encode", lambda *a, **k: False)


def _lvd_cache(indices, responses):
    """{canonical prompt: [response]} for benchmark prompts by index."""
    from lvd_tpu.eval.benchmark import get_lvd_full_prompts
    from lvd_tpu.text.templates import canonical_prompt

    prompts = get_lvd_full_prompts("lvd")
    return {canonical_prompt(prompts[i]): [r] for i, r in zip(indices, responses)}


def _main(pkg, cli, argv, cwd, monkeypatch, **patches):
    """``{pkg}.cli.{cli}.main(argv)`` in ``cwd``; returns (stdout, error)."""
    mod = importlib.import_module(f"{pkg}.cli.{cli}")
    for name, value in patches.items():
        monkeypatch.setattr(mod, name, value)
    monkeypatch.chdir(cwd)
    out, error = io.StringIO(), None
    with contextlib.redirect_stdout(out):
        try:
            mod.main(argv)
        except Exception as e:  # noqa: BLE001 — compared across packages
            error = f"{type(e).__name__}: {e}"
    return out.getvalue(), error


class Recorder:
    """A runner module: records each ``run`` and writes its frames file, so
    a later call resumes past it. ``fail_seeds`` raise."""

    version = "lvd"

    def __init__(self, runner_base, fail_seeds=()):
        self.base, self.fail_seeds, self.calls = runner_base, set(fail_seeds), []

    def run(self, parsed_layout, seed, repeat_ind=None, **kwargs):
        self.calls.append((parsed_layout, seed, repeat_ind, kwargs, self.base.img_dir))
        if seed in self.fail_seeds:
            raise RuntimeError(f"runner failed at seed {seed}")
        os.makedirs(self.base.img_dir, exist_ok=True)
        np.savez(f"{self.base.img_dir}/video_{repeat_ind}.npz", frames=np.zeros(1))


HPARAMS = ["--loss_scale", "2.5", "--loss_threshold", "350", "--max_iter", "1",
           "--max_index_step", "10", "--fg_top_p", "0.25", "--bg_top_p", "0.25",
           "--fg_weight", "1.0", "--bg_weight", "2.0", "--num_inference_steps", "4",
           "--attn_sync_weight", "0.5", "--com_loss_scale", "0.1", "--boxdiff_loss_scale", "0.2",
           "--boxdiff_normed", "0", "--boxdiff_L", "2", "--use_ratio_based_loss", "1",
           "--upsample_scale", "2", "--upsample_mode", "nearest",
           "--gligen_scheduled_sampling_beta", "0.4"]
LVD = ["--prompt-type", "lvd", "--template_version", "v0.1", "--cache-path", "cache.json"]

# name: (cache {prompt index: response}, [(argv, runner's failing seeds), ...]);
# the benchmark repeats each numeracy prompt five times, so the cached
# indices are five apart (a repeat past the cached response is a miss).
GENERATE_CASES = {
    "regenerate_repeats_hparams": ({0: 0, 5: 1, 15: 2}, [
        (["--run-model", "lvd_zeroscope", "--model", "gpt-4", *LVD, "--repeats", "2",
          "--regenerate", "2", "--seed_offset", "7", "--num_prompts", "16", "--num_frames", "24",
          *HPARAMS], ())]),
    "skip_visualize_resume": ({5: 3, 10: 4, 15: 5}, [
        (["--run-model", "lvd-plus_modelscope256", "--model", "gpt-4-1106-preview", *LVD,
          "--skip_first_prompts", "5", "--num_prompts", "11", "--seed_offset", "3",
          "--visualize", "--save-suffix", "s"], ()),
        (["--run-model", "lvd-plus_modelscope256", "--model", "gpt-4-1106-preview", *LVD,
          "--skip_first_prompts", "5", "--num_prompts", "11", "--force_run_ind", "0",
          "--save-suffix", "s"], ()),
        (["--run-model", "lvd-plus_modelscope256", "--model", "gpt-4-1106-preview", *LVD,
          "--skip_first_prompts", "5", "--num_prompts", "6", "--save-suffix", "s"], ())]),
    "errors_contained_then_raised": ({0: 6, 5: 7}, [
        (["--run-model", "lvd-gligen_modelscope256", "--model", "gpt-3.5", *LVD,
          "--num_prompts", "6", "--repeats", "2"], (6789,)),
        (["--run-model", "lvd-gligen_modelscope256", "--model", "gpt-3.5", *LVD,
          "--num_prompts", "6", "--no-continue-on-error"], (5,))]),
    "zeroscope_frames_and_baseline": ({}, [
        (["--run-model", "lvd_zeroscope", "--model", "gpt-4", *LVD, "--num_frames", "8"], ()),
        (["--run-model", "zeroscope", "--model", "gpt-4", "--prompt-type", "demo",
          "--template_version", "v0.1", "--num_frames", "8", "--repeats", "2"], ()),
        (["--run-model", "modelscope_256", "--model", "gpt-4", "--prompt-type", "lvd",
          "--template_version", "v0.1", "--num_prompts", "2", "--dry-run"], ())]),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_layer_matches(case, tmp_path, monkeypatch):
    cache, runs = GENERATE_CASES[case]
    responses = _random_responses()
    results = []
    for pkg in PACKAGES:
        cwd = tmp_path / pkg
        cwd.mkdir()
        (cwd / "cache.json").write_text(json.dumps(
            _lvd_cache(list(cache), [responses[r] for r in cache.values()])))
        gen = importlib.import_module(f"{pkg}.cli.generate")
        monkeypatch.setattr(gen.runner_base, "img_dir", gen.runner_base.img_dir)
        record = []
        for argv, fail in runs:
            rec = Recorder(gen.runner_base, fail)
            out, error = _main(pkg, "generate", argv, cwd, monkeypatch,
                               resolve_runner=lambda run_model, rec=rec: (rec, 0, 0))
            record.append((rec.calls, out, error))
        files = sorted(str(p.relative_to(cwd)) for p in cwd.rglob("*"))
        gifs = {f: _gif_frames(cwd / f) for f in files if f.endswith(".gif")}
        results.append((record, files, gifs))
    (ref, ref_files, ref_gifs), (got, got_files, got_gifs) = results
    assert got == ref and got_files == ref_files
    for f in ref_gifs:
        assert len(got_gifs[f]) == len(ref_gifs[f]) > 0
        for a, b in zip(got_gifs[f], ref_gifs[f]):
            np.testing.assert_array_equal(a, b)
    calls = [c for rec, _, _ in ref for c in rec]
    if case == "regenerate_repeats_hparams":  # the seed schedule, by hand
        assert [c[1] for c in calls] == [g * 500 + i + g * 56789 + r * 6789 + 7 for g in (0, 1)
                                         for i in (0, 5, 15) for r in (0, 1)]
        assert calls[-1][4] == "img_generations/imgs_lvd_templatev0.1_lvd_zeroscope/run0/515"
        assert calls[0][3]["upsample_mode"] == "nearest" and calls[0][3]["num_frames"] == 24
    if case == "skip_visualize_resume":
        assert len(calls) == 3 + 0 + 2 and "Output exists" in ref[1][1]
    if case == "errors_contained_then_raised":
        assert "***Error on prompt" in ref[0][1] and ref[1][2].startswith("RuntimeError")
    if case == "zeroscope_frames_and_baseline":
        assert ref[0][2].startswith("ValueError: Zeroscope runs should use --num_frames >= 24")
        assert [c[0] for c in ref[1][0]] == [{"Prompt": DEMO_PROMPT}] * 2 and not ref[2][0]


def _gif_frames(path):
    return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(Image.open(path))]


def test_prompt_batch_matches(tmp_path, monkeypatch):
    """A cache hit with ``--visualize`` (the same layout GIF, pixel for
    pixel), then a miss answered through a patched ``make_fetch`` (the same
    cache file written)."""
    results = []
    for pkg in PACKAGES:
        cwd = tmp_path / pkg
        cwd.mkdir()
        (cwd / "cache.json").write_text(json.dumps({DEMO_PROMPT: [BEAR]}))
        hit = _main(pkg, "prompt_batch", [
            "--prompt-type", "demo", "--model", "gpt-4-1106-preview", "--template_version",
            "v0.1", "--cache-path", "cache.json", "--visualize", "--img-dir", "imgs"],
            cwd, monkeypatch)
        fetched = []
        miss = _main(pkg, "prompt_batch", [
            "--prompt-type", "demo", "--model", "vicuna", "--template_version", "v0.1",
            "--cache-path", "miss.json"], cwd, monkeypatch,
            make_fetch=lambda cfg, prompt: lambda s: fetched.append((cfg.model, prompt, s))
            or SAMPLE_RESPONSE)
        results.append((hit, miss, fetched, (cwd / "miss.json").read_text(),
                        sorted(os.listdir(cwd / "imgs")), _gif_frames(cwd / "imgs/layout_0.gif")))
    ref, got = results
    assert got[:5] == ref[:5] and "Cache hit" in ref[0][0] and ref[4] == ["layout_0.gif"]
    assert len(got[5]) == len(ref[5]) == 24
    for a, b in zip(got[5], ref[5]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prompt_type", ["lvd", "lvd_dynamic"])
def test_eval_stage_one_matches(prompt_type, tmp_path, monkeypatch):
    """The per-task table over a cache of a few benchmark prompts, each task
    represented; the other prompts are cache misses, skipped."""
    responses = _random_responses()
    indices = [0, 5, 99, 100, 150, 200, 250, 300, 320, 340, 400, 401, 450]
    outs = []
    for pkg in PACKAGES:
        cwd = tmp_path / pkg
        cwd.mkdir()
        (cwd / "cache.json").write_text(json.dumps(
            _lvd_cache(indices, [responses[i % len(responses)] for i in range(len(indices))])))
        outs.append(_main(pkg, "eval_stage_one", [
            "--model", "gpt-3.5-turbo", "--prompt-type", prompt_type, "--cache-path",
            "cache.json"], cwd, monkeypatch))
    assert outs[0] == outs[1] and outs[0][1] is None
    assert "=== Stage-1 results ===" in outs[0][0] and "overall" in outs[0][0]


class FakeJudge:
    """OWL-ViT's ``detect`` contract: four boxes a frame, drawn from the
    frame's content, labels over the queries."""

    def __init__(self, model_path=None):
        self.model_path = model_path

    def detect(self, image, texts):
        rng = np.random.default_rng([int(image.astype(np.int64).sum()), len(texts)])
        xy = rng.random((4, 2)) * 0.6
        boxes = np.concatenate([xy, xy + 0.1 + rng.random((4, 2)) * 0.3], 1)
        return (boxes.astype(np.float32), rng.random(4).astype(np.float32),
                rng.integers(0, len(texts), 4))


@pytest.mark.parametrize("flags", [[], ["--class-aware-nms", "--num_eval_frames", "4"]])
def test_eval_owl_vit_matches(flags, tmp_path, monkeypatch):
    """Scores and eval.json over a run dir of frames files (.npz, one a
    prompt; prompt 101's directory is missing and skipped)."""
    outs = []
    for pkg in PACKAGES:
        cwd = tmp_path / pkg
        vis = importlib.import_module(f"{pkg}.utils.vis")
        for ind in (97, 98, 99, 100, 102):
            rng = np.random.default_rng(ind)
            vis.save_frames(str(cwd / f"run0/{ind}/video_0"),
                            rng.integers(0, 256, (8, 32, 48, 3), dtype=np.uint8), formats="npz")
        out = _main(pkg, "eval_owl_vit", [
            "--run_base_path", "run0", "--skip_first_prompts", "97", "--num_prompts", "6",
            "--detection_score_threshold", "0.2", "--save-eval", *flags], cwd, monkeypatch,
            OwlVitJudge=FakeJudge)
        outs.append((out, (cwd / "run0/eval.json").read_text()))
    assert outs[0] == outs[1] and outs[0][0][1] is None
    assert "Expected exactly one video for ind 101" in outs[0][0][0]
    assert json.loads(outs[0][1])["sample_counts_overall"] == 5


def test_clis_run_on_the_card_unless_the_cpu_is_asked(tmp_path, monkeypatch):
    """Without LVD_PLATFORM the runners' pipeline goes to the card, which is
    missing here: it raises, nothing falls back. An unknown platform
    raises before any work."""
    import torch

    gen = importlib.import_module("lvd_tpu_torch.cli.generate")
    (tmp_path / "cache.json").write_text(json.dumps({DEMO_PROMPT: [BEAR]}))
    monkeypatch.setattr(gen.runner_base, "img_dir", gen.runner_base.img_dir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LVD_TINY", "1")
    argv = ["--run-model", "lvd_modelscope256", "--model", "gpt-4", "--prompt-type", "demo",
            "--template_version", "v0.1", "--cache-path", "cache.json"]
    _, error = _main("lvd_tpu_torch", "generate", argv, tmp_path, monkeypatch)
    assert error.startswith("RuntimeError: lvd_tpu_torch: no CUDA device")
    monkeypatch.setenv("LVD_PLATFORM", "tpu")
    _, error = _main("lvd_tpu_torch", "generate", argv, tmp_path, monkeypatch)
    assert error.startswith("ValueError: LVD_PLATFORM='tpu'")


def test_owl_vit_judge_runs_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    """The judge's model, its inputs and its target sizes go to the device
    LVD_PLATFORM asks for: without it the card, missing here, so it raises;
    under cpu the CPU. transformers' classes are stand-ins (no weights)."""
    import types

    import torch

    placed = []

    class Inputs(dict):
        def to(self, device):
            placed.append(("inputs", torch.device(device)))
            return self

    class Processor:
        @classmethod
        def from_pretrained(cls, path):
            return cls()

        def __call__(self, text, images, return_tensors):
            return Inputs(pixel_values=torch.zeros(1))

        def post_process_object_detection(self, outputs, target_sizes, threshold):
            placed.append(("target_sizes", target_sizes.device))
            return [{"boxes": torch.tensor([[12.0, 8.0, 24.0, 16.0]]),
                     "scores": torch.tensor([0.5]), "labels": torch.tensor([0])}]

    class Model:
        @classmethod
        def from_pretrained(cls, path):
            return cls()

        def to(self, device):
            placed.append(("model", torch.device(device)))
            return self

        def eval(self):
            return self

        def __call__(self, **inputs):
            return None

    fake = types.ModuleType("transformers")
    fake.OwlViTProcessor, fake.OwlViTForObjectDetection = Processor, Model
    monkeypatch.setitem(sys.modules, "transformers", fake)
    owl = importlib.import_module("lvd_tpu_torch.cli.eval_owl_vit")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        owl.OwlVitJudge("judge")
    assert placed == []
    monkeypatch.setenv("LVD_PLATFORM", "cpu")
    boxes, scores, labels = owl.OwlVitJudge("judge").detect(
        np.zeros((32, 48, 3), np.uint8), ["bear"])
    cpu = torch.device("cpu")
    assert placed == [("model", cpu), ("inputs", cpu), ("target_sizes", cpu)]
    np.testing.assert_allclose(boxes, [[0.25, 0.25, 0.5, 0.5]])
    assert scores.tolist() == [0.5] and labels.tolist() == [0]


BLOCKED_RUN = r"""
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "lvd_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.argv = ["generate"] + sys.argv[1:]
runpy.run_module("lvd_tpu_torch.cli.generate", run_name="__main__")
assert not any(m.split(".")[0] in ("jax", "lvd_tpu") for m in sys.modules), "leaked"
"""


@pytest.mark.parametrize("run_model", ["lvd_modelscope256", "lvd-gligen_modelscope256",
                                       "lvd-plus_modelscope256", "modelscope_256"])
def test_generate_cli_end_to_end_on_cpu(run_model, tmp_path):
    """tests/test_cli_integration.py's runs, through the port: a 4-frame GIF
    of the tiny preset's 96 x 64 and its frames file; lvd_modelscope256 in a
    process that cannot import jax, jaxlib or lvd_tpu."""
    (tmp_path / "cache_demo.json").write_text(json.dumps({DEMO_PROMPT: [BEAR]}))
    args = ["--run-model", run_model, "--prompt-type", "demo", "--model", "gpt-4-1106-preview",
            "--template_version", "v0.1", "--cache-path", "cache_demo.json", "--num_frames", "4",
            "--num_inference_steps", "4", "--no-continue-on-error"]
    if run_model.startswith("lvd_"):
        args += ["--max_index_step", "2", "--max_iter", "1"]
    elif run_model.startswith("lvd-plus"):
        args += ["--max_index_step", "2", "--max_iter", "1",
                 "--gligen_scheduled_sampling_beta", "0.75"]
    elif run_model.startswith("lvd-gligen"):
        args += ["--gligen_scheduled_sampling_beta", "0.5"]
    cmd = ([sys.executable, "-c", BLOCKED_RUN] if run_model == "lvd_modelscope256"
           else [sys.executable, "-m", "lvd_tpu_torch.cli.generate"])
    env = {k: v for k, v in os.environ.items()
           if k not in ("LVD_CHECKPOINT_ROOT", "LVD_ALLOW_RANDOM_WEIGHTS")}
    env.update(LVD_TINY="1", LVD_PLATFORM="cpu", PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    result = subprocess.run(cmd + args, cwd=tmp_path, env=env, capture_output=True, text=True,
                            timeout=600)
    assert result.returncode == 0, result.stdout[-2000:] + result.stderr[-2000:]
    out_dir = tmp_path / f"img_generations/imgs_demo_templatev0.1_gpt-4-1106-preview_{run_model}/run0/0"
    gif = Image.open(out_dir / "video_0.gif")
    assert gif.size == (96, 64) and gif.n_frames == 4
    vis = importlib.import_module("lvd_tpu_torch.utils.vis")
    name = next(f for f in ("video_0.joblib", "video_0.npz") if (out_dir / f).exists())
    frames = vis.load_video(str(out_dir / name))
    assert frames.shape == (4, 64, 96, 3) and frames.dtype == np.uint8
    assert frames.std() > 0
