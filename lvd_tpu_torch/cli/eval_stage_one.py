"""Stage-1 (layout-level) benchmark evaluation CLI (counterpart of
lvd_tpu/cli/eval_stage_one.py).

Parity target of both: the reference's scripts/eval_stage_one.py. Scores cached (or
freshly queried) layouts with the per-task predicates and prints per-task and
overall success rates.

Usage:
  python -m lvd_tpu_torch.cli.eval_stage_one --model gpt-3.5-turbo \
      --template_version v0.1 [--prompt-type lvd] [--cache-path ...]
"""

from __future__ import annotations

import argparse
from collections import defaultdict

from ..eval.harness import evaluate_with_layout
from ..text import cache as cache_mod
from ..text.client import MODEL_NAMES, get_full_model_name, get_llm_kwargs, make_fetch
from ..text.parser import get_parsed_layout_with_cache
from ..utils.platform import maybe_force_platform
from ..text.templates import (
    TEMPLATE_VERSIONS,
    canonical_prompt,
    get_num_parsed_layout_frames,
    get_prompts,
)


def main(argv=None):
    maybe_force_platform()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--prompt-type", type=str, default="lvd")
    p.add_argument("--model", choices=MODEL_NAMES, required=True)
    p.add_argument("--template_version", default="v0.1", choices=TEMPLATE_VERSIONS)
    p.add_argument("--cache-path", default=None, type=str)
    p.add_argument("--allow-cache-miss", action="store_true",
                   help="Query the LLM on cache misses (needs an API key)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    model = get_full_model_name(args.model)
    path = args.cache_path or (
        f"cache/cache_{args.prompt_type}_{args.template_version}_{model}.json"
    )
    cache = cache_mod.ResponseCache(path)
    cache.load(allow_nonexist=args.allow_cache_miss)
    print(f"Cache path: {path} ({len(cache)} prompts cached)")

    json_template = "json" in args.template_version
    num_frames = get_num_parsed_layout_frames(args.template_version)

    fetch_factory = None
    if args.allow_cache_miss:
        _, llm_config = get_llm_kwargs(args.model, args.template_version)
        fetch_factory = lambda prompt: make_fetch(llm_config, prompt)

    prompt_predicates = get_prompts(args.prompt_type, return_predicates=True)

    successes = defaultdict(int)
    counts = defaultdict(int)
    misses = 0
    for prompt, predicate in prompt_predicates:
        prompt = canonical_prompt(prompt)
        try:
            parsed_layout = get_parsed_layout_with_cache(
                prompt,
                cache,
                fetch=fetch_factory(prompt) if fetch_factory else None,
                cache_miss_allowed=args.allow_cache_miss,
                json_template=json_template,
            )
        except (KeyError, ValueError) as e:
            print(f"Skipping prompt (no layout): {prompt!r} ({e})")
            misses += 1
            continue
        task, ok = evaluate_with_layout(
            parsed_layout,
            predicate,
            num_parsed_layout_frames=num_frames,
            height=512,
            width=512,
            verbose=args.verbose,
        )
        successes[task] += int(ok)
        counts[task] += 1

    print("\n=== Stage-1 results ===")
    total_s, total_c = 0, 0
    for task in sorted(counts):
        rate = successes[task] / counts[task]
        total_s += successes[task]
        total_c += counts[task]
        print(f"{task:18s} {successes[task]:4d}/{counts[task]:<4d} = {rate:.1%}")
    if total_c:
        print(f"{'overall':18s} {total_s:4d}/{total_c:<4d} = {total_s / total_c:.1%}")
    if misses:
        print(f"({misses} prompts skipped due to cache misses)")


if __name__ == "__main__":
    main()
