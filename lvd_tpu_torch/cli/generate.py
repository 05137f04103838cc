"""Stage-2 batch generation CLI (counterpart of lvd_tpu/cli/generate.py).

Parity target of both: the reference's generate.py. Same flags, run-directory layout
(`img_generations/imgs_{type}_template{v}[_{model}]_{run_model}{suffix}/run{k}/{ind}/`),
deterministic seed schedule (`seed = ind + repeat*6789 + seed_offset
(+ regenerate*56789)`), resume-by-existing-file, per-prompt exception
containment, and cache-only layout loading (no LLM key needed).

Usage:
  python -m lvd_tpu_torch.cli.generate --run-model lvd_zeroscope --prompt-type lvd \
      --model gpt-4 --template_version v0.1 [hyperparameter flags]

Runs on the card; ``LVD_PLATFORM=cpu`` runs it on the CPU, and ``LVD_TINY=1``
with lvd_tpu's tiny models (runners/base.py).
"""

from __future__ import annotations

import argparse
import importlib
import os
import time
import traceback

import torch

from ..text import cache as cache_mod
from ..text.client import MODEL_NAMES, get_full_model_name
from ..text.parser import get_parsed_layout
from ..text.templates import TEMPLATE_VERSIONS, canonical_prompt, get_prompts
from ..layout.condition import parsed_layout_to_condition
from ..utils import vis
from ..utils.platform import maybe_force_platform
from ..runners import base as runner_base

LARGE_CONSTANT2 = 56789
LARGE_CONSTANT3 = 6789

RUN_MODELS = [
    "lvd",
    "lvd_zeroscope",
    "lvd_modelscope256",
    "lvd_modelscope512",
    "lvd-gligen_modelscope256",
    "lvd-gligen_zeroscope",
    "lvd-plus_modelscope256",
    "lvd-plus_zeroscope",
    "modelscope",
    "modelscope_256",
    "zeroscope",
    "zeroscope_xl",
]

FLOAT_ARGS = [
    "fg_top_p", "bg_top_p", "fg_weight", "bg_weight", "loss_threshold",
    "loss_scale", "boxdiff_loss_scale", "com_loss_scale",
    "gligen_scheduled_sampling_beta", "attn_sync_weight",
]
INT_ARGS = [
    "num_inference_steps", "max_iter", "max_index_step", "num_frames",
    "use_ratio_based_loss", "boxdiff_normed", "boxdiff_L",
    "upsample_scale",
]
STR_ARGS = ["upsample_mode"]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--save-suffix", default=None, type=str)
    p.add_argument("--model", choices=MODEL_NAMES, required=True,
                   help="LLM whose cached layouts to load")
    p.add_argument("--repeats", default=1, type=int)
    p.add_argument("--regenerate", default=1, type=int)
    p.add_argument("--force_run_ind", default=None, type=int)
    p.add_argument("--skip_first_prompts", default=0, type=int)
    p.add_argument("--seed_offset", default=0, type=int)
    p.add_argument("--num_prompts", default=None, type=int)
    p.add_argument("--run-model", default="lvd", choices=RUN_MODELS)
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--no-continue-on-error", action="store_true")
    p.add_argument("--prompt-type", type=str, default="demo")
    p.add_argument("--template_version", choices=TEMPLATE_VERSIONS, required=True)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--cache-path", default=None, type=str,
                   help="Override the layout-cache path")
    for a in FLOAT_ARGS:
        p.add_argument("--" + a, default=None, type=float)
    for a in INT_ARGS:
        p.add_argument("--" + a, default=None, type=int)
    for a in STR_ARGS:
        p.add_argument("--" + a, default=None, type=str)
    return p


def _runner(name: str):
    return importlib.import_module(f".runners.{name}", "lvd_tpu_torch")


def resolve_runner(run_model: str):
    option = run_model.split("_", 1)[1] if "_" in run_model else ""
    if run_model.startswith("lvd-plus"):
        mod = _runner("lvd_plus")
        h, w = mod.init(option or "modelscope256")
    elif run_model.startswith("lvd-gligen"):
        mod = _runner("lvd_gligen")
        h, w = mod.init(option or "modelscope256")
    elif run_model == "lvd" or run_model.startswith("lvd_"):
        mod = _runner("lvd")
        h, w = mod.init(option or "modelscope512")
    elif run_model in ("modelscope", "modelscope_256"):
        mod = _runner("modelscope_dpm")
        h, w = mod.init(option)
    elif run_model in ("zeroscope", "zeroscope_xl"):
        mod = _runner("zeroscope_dpm")
        h, w = mod.init(option)
    else:
        raise ValueError(f"Unknown run model: {run_model}")
    assert mod.version == run_model.split("_")[0], (mod.version, run_model)
    return mod, h, w


def main(argv=None):
    maybe_force_platform()
    args = build_parser().parse_args(argv)
    run_model = args.run_model
    baseline = run_model in ("modelscope", "modelscope_256", "zeroscope", "zeroscope_xl")
    json_template = "json" in args.template_version
    model = get_full_model_name(args.model)

    if "zeroscope" in run_model and not baseline and (
        args.num_frames is None or args.num_frames < 24
    ):
        raise ValueError(
            "Zeroscope runs should use --num_frames >= 24 for good results."
        )

    if not args.dry_run:
        runner, _, _ = resolve_runner(run_model)
    else:
        runner = None

    cache = None
    if not baseline:
        path = args.cache_path or (
            f'cache/cache_{args.prompt_type.replace("lmd_", "")}'
            f"_{args.template_version}_{model}.json"
        )
        cache = cache_mod.ResponseCache(path)
        cache.load(allow_nonexist=False)
        print(f"Loaded layout cache: {path}")

    prompts = get_prompts(args.prompt_type)

    suffix = f"_{args.save_suffix}" if args.save_suffix else ""
    model_dir = "" if model == "gpt-4" else f"_{model}"
    base_save_dir = (
        f"img_generations/imgs_{args.prompt_type}_template{args.template_version}"
        f"{model_dir}_{run_model}{suffix}"
    )

    if args.force_run_ind is not None:
        run_ind = args.force_run_ind
    else:
        run_ind = 0
        while os.path.exists(f"{base_save_dir}/run{run_ind}"):
            run_ind += 1
    save_dir = f"{base_save_dir}/run{run_ind}"
    print(f"Save dir: {save_dir}")

    run_kwargs = {
        a: getattr(args, a)
        for a in FLOAT_ARGS + INT_ARGS + STR_ARGS
        if getattr(args, a) is not None
    }

    ind = 0
    if args.regenerate > 1 and args.skip_first_prompts != 0:
        raise ValueError("--regenerate > 1 requires --skip_first_prompts 0")

    for regenerate_ind in range(args.regenerate):
        if cache is not None:
            cache.reset_access()
        for prompt_ind, prompt in enumerate(prompts):
            if prompt_ind < args.skip_first_prompts:
                ind += 1
                continue
            if args.num_prompts is not None and prompt_ind >= (
                args.skip_first_prompts + args.num_prompts
            ):
                ind += 1
                continue

            prompt = canonical_prompt(prompt)

            resp = None
            if cache is not None:
                resp = cache.get(prompt)
                if resp is None:
                    print(f"Cache miss, skipping prompt: {prompt}")
                    ind += 1
                    continue

            out_dir = f"{save_dir}/{ind}"
            runner_base.img_dir = out_dir
            existing = (
                [
                    f
                    for f in os.listdir(out_dir)
                    if f.startswith("video")
                    and (f.endswith("joblib") or f.endswith("npz"))
                ]
                if os.path.exists(out_dir)
                else []
            )
            if len(existing) >= args.repeats:
                print(f"Output exists at {out_dir}, skipping")
                ind += 1
                continue

            os.makedirs(out_dir, exist_ok=True)
            try:
                if baseline:
                    parsed_layout = {"Prompt": prompt}
                else:
                    parsed_layout, _ = get_parsed_layout(
                        prompt, response=resp, json_template=json_template
                    )

                if args.dry_run:
                    ind += 1
                    continue

                if args.visualize:
                    condition = parsed_layout_to_condition(
                        parsed_layout, height=512, width=512
                    )
                    vis.show_video_boxes(condition, f"{out_dir}/boxes.gif")

                seed_base = ind + regenerate_ind * LARGE_CONSTANT2
                for repeat_ind in range(args.repeats):
                    seed = seed_base + repeat_ind * LARGE_CONSTANT3 + args.seed_offset
                    runner.run(
                        parsed_layout, seed=seed, repeat_ind=repeat_ind, **run_kwargs
                    )
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — batch must survive one bad prompt
                print(f"***Error on prompt {prompt!r}: {e}***")
                traceback.print_exc()
                if isinstance(e, torch.cuda.OutOfMemoryError):
                    print("Out of memory; sleeping 10s")
                    time.sleep(10)
                if args.no_continue_on_error:
                    raise
            ind += 1

    if cache is not None and cache.values_accessed() != len(prompts):
        print(
            f"**Cache hit {cache.values_accessed()} time(s) for {len(prompts)} "
            "prompts — there may be cache misses or extra cache entries.**"
        )


if __name__ == "__main__":
    main()
