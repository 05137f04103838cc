"""Stage-1 batch CLI: query the LLM for layouts, cache, visualize
(counterpart of lvd_tpu/cli/prompt_batch.py).

Parity target of both: the reference's prompt_batch.py. For each prompt: on cache
hit, parse; on miss, auto-query the LLM (or read a pasted response with
--no-auto-query) and save the reconstruction to the cache after a full parse.

Usage:
  python -m lvd_tpu_torch.cli.prompt_batch --prompt-type lvd --model gpt-4 \
      --template_version v0.1 [--auto-query] [--visualize]
"""

from __future__ import annotations

import argparse
import os
import sys

from ..layout.condition import parsed_layout_to_condition
from ..text import cache as cache_mod
from ..text.client import MODEL_NAMES, get_full_model_name, get_llm_kwargs, make_fetch
from ..text.parser import get_parsed_layout
from ..text.templates import TEMPLATE_VERSIONS, canonical_prompt, get_prompts
from ..utils import vis
from ..utils.platform import maybe_force_platform


def multiline_input(prompt: str) -> str:
    print(prompt)
    lines = []
    while True:
        line = sys.stdin.readline()
        if not line or line.strip() == "":
            break
        lines.append(line.rstrip("\n"))
    return "\n".join(lines)


def main(argv=None):
    maybe_force_platform()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--prompt-type", type=str, default="demo")
    p.add_argument("--model", choices=MODEL_NAMES, required=True)
    p.add_argument("--template_version", choices=TEMPLATE_VERSIONS, required=True)
    p.add_argument("--auto-query", action="store_true", default=True)
    p.add_argument("--no-auto-query", dest="auto_query", action="store_false")
    p.add_argument("--always-save", action="store_true", default=True)
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--cache-path", default=None, type=str)
    p.add_argument("--img-dir", default="imgs", type=str)
    args = p.parse_args(argv)

    model, llm_config = get_llm_kwargs(args.model, args.template_version)
    json_template = "json" in args.template_version

    path = args.cache_path or (
        f"cache/cache_{args.prompt_type}_{args.template_version}"
        f"_{get_full_model_name(args.model)}.json"
    )
    cache = cache_mod.ResponseCache(path)
    cache.load(allow_nonexist=True)
    print(f"Cache path: {path}")

    prompts = get_prompts(args.prompt_type)

    for ind, prompt in enumerate(prompts):
        prompt = canonical_prompt(prompt)
        resp = cache.get(prompt)
        if resp is not None:
            print(f"Cache hit: {prompt}")
            parsed_layout, _ = get_parsed_layout(
                prompt, response=resp, json_template=json_template
            )
        else:
            print(f"Cache miss: {prompt}")
            max_attempts = 3
            parsed_layout = None
            for attempt in range(max_attempts):
                try:
                    if args.auto_query:
                        parsed_layout, reconstructed = get_parsed_layout(
                            prompt,
                            fetch=make_fetch(llm_config, prompt),
                            json_template=json_template,
                            max_partial_response_retries=3,
                        )
                    else:
                        pasted = multiline_input(
                            "Paste the LLM response (empty line ends):"
                        )
                        parsed_layout, reconstructed = get_parsed_layout(
                            prompt, response=pasted, json_template=json_template
                        )
                    break
                except (ValueError, SyntaxError, TypeError) as e:
                    print(f"Parse error ({e}); attempt {attempt + 1}/{max_attempts}")
            if parsed_layout is None:
                print(f"Giving up on prompt: {prompt}")
                continue
            cache.add(prompt, reconstructed)

        if args.visualize:
            condition = parsed_layout_to_condition(
                parsed_layout, height=512, width=512, verbose=True
            )
            os.makedirs(args.img_dir, exist_ok=True)
            out = f"{args.img_dir}/layout_{ind}.gif"
            vis.show_video_boxes(condition, out)
            print(f"Layout visualization saved to {out}")

    print(f"Done: {len(prompts)} prompts, cache accesses: {cache.values_accessed()}")


if __name__ == "__main__":
    main()
