"""Layout-response parsing: raw LLM text -> ``parsed_layout`` dict.

A copy of lvd_tpu/text/parser.py; parity target of both: the reference's
utils/llm.py:169-386 (`get_parsed_layout*`).
The protocol is line-oriented: six ``Frame k:`` lines each carrying a Python
literal list of ``{'id', 'name', 'box'}`` dicts, then a ``Background keyword:``
free-text line. Supports partial-response continuation (re-querying the LLM
with the accumulated tail as a suffix) and a JSON-object response variant.

A ``parsed_layout`` is ``{"Frame 1"..: [..], "Background keyword": str,
"Prompt": str}`` — the stage-1 -> stage-2 data contract.
"""

from __future__ import annotations

import ast
import json
from typing import Callable, Optional

from .templates import REQUIRED_LINES, REQUIRED_LINES_AST

STRIP_CHARS = " \t\n`"


class LayoutParseError(ValueError):
    pass


def _clean_literal_line(content: str) -> str:
    # LLMs occasionally append " - comment" or prefix list items with "-".
    content = content.split(" - ")[0].strip()
    if content.startswith("-"):
        content = content[content.find("-") + 1 :].strip()
    return content


def parse_layout_response(
    prompt: str,
    response: Optional[str] = None,
    fetch: Optional[Callable[[Optional[str]], str]] = None,
    max_partial_response_retries: int = 1,
    save_leading_text: bool = True,
):
    """Parse one (possibly multi-fetch) layout response.

    Exactly one of ``response`` (a fixed raw response, e.g. from cache) or
    ``fetch`` (``fetch(suffix) -> raw response``, suffix used for
    partial-response continuation) must be provided.

    Returns ``(parsed_layout, reconstructed_response)`` where the
    reconstruction re-parses to the same layout and is what gets cached.
    """
    if (response is None) == (fetch is None):
        raise ValueError("Provide exactly one of `response` or `fetch`")
    if response is not None and max_partial_response_retries != 1:
        raise ValueError("A fixed response allows no partial continuation")

    parsed: dict = {}
    pieces: list[str] = []
    process_index = 0
    retries = 0
    suffix: Optional[str] = None
    text = ""

    while process_index < len(REQUIRED_LINES):
        retries += 1
        if retries > max_partial_response_retries:
            raise LayoutParseError(
                f"Too many partial-response attempts for prompt {prompt!r}; "
                f"last response: {text!r}"
            )
        text = response if response is not None else fetch(suffix)

        marker = REQUIRED_LINES[process_index]
        if marker in text:
            leading, _, text = text.partition(marker)
            if pieces and pieces[-1].endswith(marker):
                # Continuation fetch: the reconstruction already ends with this
                # marker; re-emitting it (or the echoed tail) would corrupt the
                # round-trip.
                pass
            elif save_leading_text:
                pieces.append(leading + marker)
            else:
                pieces.append(marker)

        advanced = False
        while process_index < len(REQUIRED_LINES):
            line = REQUIRED_LINES[process_index]
            is_last = process_index + 1 == len(REQUIRED_LINES)
            next_line = None if is_last else REQUIRED_LINES[process_index + 1]

            if is_last:
                content = text.strip(STRIP_CHARS)
                consumed, text = text, ""
            elif next_line in text:
                idx = text.find(next_line)
                content = text[:idx].strip(STRIP_CHARS)
                consumed, text = text[: idx + len(next_line)], text[idx + len(next_line) :]
            else:
                break

            if REQUIRED_LINES_AST[process_index]:
                content = _clean_literal_line(content)
                try:
                    content = ast.literal_eval(content)
                except (SyntaxError, ValueError) as e:
                    raise LayoutParseError(
                        f"Cannot evaluate layout line {line!r}: {content!r}: {e}"
                    ) from e

            parsed[line.rstrip(":")] = content
            pieces.append(consumed)
            process_index += 1
            advanced = True

        if process_index >= len(REQUIRED_LINES):
            break
        if not advanced and process_index == 0:
            # Nothing matched at all: retry from scratch.
            suffix = None
            continue
        # Partial match: continue the generation from where it stopped.
        suffix = "\n" + text.rstrip(STRIP_CHARS) + "\n" + REQUIRED_LINES[process_index]

    parsed["Prompt"] = prompt
    return parsed, "".join(pieces)


def parse_layout_response_json(
    prompt: str,
    response: Optional[str] = None,
    fetch: Optional[Callable[[Optional[str]], str]] = None,
    **_: object,
):
    """JSON-object response variant (reference utils/llm.py:277-328).

    Accepts JSON with minor LLM-isms (single quotes, trailing commas,
    unquoted keys handled via a Python-literal fallback).
    """
    if (response is None) == (fetch is None):
        raise ValueError("Provide exactly one of `response` or `fetch`")
    text = response if response is not None else fetch(None)
    text = text.strip(STRIP_CHARS)
    if text.startswith("Response:"):
        text = text[len("Response:") :].strip(STRIP_CHARS)
    try:
        parsed = json.loads(text)
    except json.JSONDecodeError:
        try:
            parsed = ast.literal_eval(text)
        except (SyntaxError, ValueError) as e:
            raise LayoutParseError(f"Cannot parse JSON layout: {text!r}: {e}") from e
    if not isinstance(parsed, dict):
        raise LayoutParseError(f"JSON layout is not an object: {text!r}")
    parsed["Prompt"] = prompt
    return parsed, text


def get_parsed_layout(
    prompt: str,
    *,
    response: Optional[str] = None,
    fetch: Optional[Callable[[Optional[str]], str]] = None,
    json_template: bool = False,
    **kwargs,
):
    fn = parse_layout_response_json if json_template else parse_layout_response
    return fn(prompt, response=response, fetch=fetch, **kwargs)


def get_parsed_layout_with_cache(
    prompt: str,
    cache,
    fetch: Optional[Callable[[Optional[str]], str]] = None,
    max_retries: int = 3,
    cache_miss_allowed: bool = True,
    json_template: bool = False,
    max_partial_response_retries: int = 1,
    verbose: bool = False,
):
    """Cache-first parse (reference utils/llm.py:331-386): on a hit, parse the
    cached raw response; on a miss, query+parse with retries and store the
    reconstruction only after a full successful parse."""
    cached = cache.get(prompt)
    if cached is not None:
        if verbose:
            print(f"Cache hit: {prompt}")
        parsed, _ = get_parsed_layout(
            prompt, response=cached, json_template=json_template
        )
        return parsed

    if verbose:
        print(f"Cache miss: {prompt}")
    if not cache_miss_allowed:
        raise KeyError(f"Cache miss not allowed for prompt: {prompt!r}")
    if fetch is None:
        raise ValueError("Cache miss but no `fetch` callable provided")

    last_error = None
    for _ in range(max_retries):
        try:
            parsed, reconstructed = get_parsed_layout(
                prompt,
                fetch=fetch,
                json_template=json_template,
                max_partial_response_retries=max_partial_response_retries,
            )
            cache.add(prompt, reconstructed)
            return parsed
        except Exception as e:  # noqa: BLE001 — mirror reference retry-all
            last_error = e
            if verbose:
                print(f"Parse error ({e}), retrying")
    raise LayoutParseError(
        f"Too many non-successful attempts on prompt {prompt!r}: {last_error}"
    )
