"""HTTP client for the stage-1 layout LLM.

A copy of lvd_tpu/text/client.py; parity target of both: the reference's
utils/llm.py:10-166 (`model_names`,
`get_llm_kwargs`, `get_layout`, `get_full_chat_prompt`, `get_full_prompt`).
Chat models (gpt-*) hit ``{api_base}/chat/completions``; local completion
models (vicuna/llama/...) hit ``{api_base}/completions`` on localhost:8000.
Network IO stays host-side Python (urllib) — it is never part of the card's
hot path.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

from .templates import STOP, TEMPLATES

MODEL_NAMES = [
    "vicuna",
    "vicuna-13b",
    "vicuna-13b-v1.3",
    "vicuna-33b-v1.3",
    "Llama-2-7b-hf",
    "Llama-2-13b-hf",
    "Llama-2-70b-hf",
    "FreeWilly2",
    "gpt-3.5-turbo",
    "gpt-3.5",
    "gpt-4",
    "gpt-4-1106-preview",
]

_ALIASES = {"gpt-3.5": "gpt-3.5-turbo", "vicuna": "vicuna-13b"}


def get_full_model_name(model: str) -> str:
    return _ALIASES.get(model, model)


@dataclasses.dataclass
class LLMConfig:
    model: str
    template: object
    api_base: str
    max_tokens: int = 900
    temperature: float = 0.25
    headers: dict = dataclasses.field(default_factory=dict)
    stop: str = STOP

    @property
    def is_chat(self) -> bool:
        return "gpt" in self.model


def get_llm_kwargs(model: str, template_version: str) -> tuple[str, LLMConfig]:
    """Resolve model name + template version into a request config."""
    model = get_full_model_name(model)
    template = TEMPLATES[template_version]

    lowered = model.lower()
    if any(k in lowered for k in ("vicuna", "llama", "freewilly")):
        api_base = os.environ.get("LVD_LOCAL_LLM_API", "http://localhost:8000/v1")
        headers = {}
    else:
        api_key = os.environ.get("OPENAI_API_KEY", "")
        api_base = os.environ.get("OPENAI_API_BASE", "https://api.openai.com/v1")
        headers = {"Authorization": f"Bearer {api_key}"}

    return model, LLMConfig(
        model=model, template=template, api_base=api_base, headers=headers
    )


def get_full_prompt(template, prompt: str, suffix: Optional[str] = None) -> str:
    """Flatten template + prompt for completion-style endpoints."""
    if isinstance(template, str):
        full = template.replace("{prompt}", prompt)
    else:
        full = (
            "\n\n".join(m["content"] for m in template)
            + f"\n\nCaption: {prompt}\nReasoning:"
        )
    if suffix:
        full = full.strip() + suffix
    return full


def get_full_chat_prompt(
    template, prompt: str, suffix: Optional[str] = None, query_prefix: str = "Caption: "
):
    if isinstance(template, str):
        return [
            {"role": "system", "content": "You are a helpful assistant."},
            {"role": "user", "content": get_full_prompt(template, prompt, suffix).strip()},
        ]
    if suffix is not None:
        # Chat APIs cannot continue mid-message; fold the partial output into
        # the user turn so the model resumes from the accumulated tail.
        return [
            *template,
            {"role": "user", "content": query_prefix + prompt + suffix},
        ]
    return [*template, {"role": "user", "content": query_prefix + prompt}]


def _post_json(url: str, payload: dict, headers: dict, timeout: float = 120.0) -> dict:
    data = json.dumps(payload).encode("utf-8")
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json", **headers}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def get_layout(
    prompt: str,
    llm_config: LLMConfig,
    suffix: Optional[str] = None,
    query_prefix: str = "Caption: ",
    verbose: bool = False,
    _post: Callable = _post_json,
    max_attempts: int = 5,
    backoff_after: int = 3,
    backoff_seconds: float = 60.0,
) -> str:
    """Query the LLM once (with retries) and return the raw response text."""
    if verbose:
        print(f"Querying layout for prompt {prompt!r} (suffix={suffix!r})")

    attempts = 0
    while True:
        try:
            if llm_config.is_chat:
                payload = {
                    "model": llm_config.model,
                    "messages": get_full_chat_prompt(
                        llm_config.template, prompt, suffix, query_prefix
                    ),
                    "max_tokens": llm_config.max_tokens,
                    "temperature": llm_config.temperature,
                }
                if isinstance(llm_config.template, str):
                    payload["stop"] = llm_config.stop
                out = _post(
                    f"{llm_config.api_base}/chat/completions",
                    payload,
                    llm_config.headers,
                )
                return out["choices"][0]["message"]["content"]
            payload = {
                "model": llm_config.model,
                "prompt": get_full_prompt(llm_config.template, prompt, suffix).strip(),
                "max_tokens": llm_config.max_tokens,
                "temperature": llm_config.temperature,
                "stop": llm_config.stop,
            }
            out = _post(
                f"{llm_config.api_base}/completions", payload, llm_config.headers
            )
            return out["choices"][0]["text"]
        except (urllib.error.URLError, KeyError, json.JSONDecodeError, OSError) as e:
            attempts += 1
            print(f"LLM request failed ({e}); attempt {attempts}/{max_attempts}")
            if attempts >= max_attempts:
                raise RuntimeError(
                    f"Giving up after {attempts} failed LLM requests"
                ) from e
            if attempts >= backoff_after:
                print(f"Backing off {backoff_seconds:.0f}s before retrying")
                time.sleep(backoff_seconds)


def make_fetch(llm_config: LLMConfig, prompt: str, **kwargs) -> Callable:
    """Adapter: ``fetch(suffix)`` closure for the layout parser."""

    def fetch(suffix: Optional[str]) -> str:
        return get_layout(prompt, llm_config, suffix=suffix, **kwargs)

    return fetch
