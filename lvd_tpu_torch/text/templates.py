"""Prompt constants the port's generation path needs (copied from
lvd_tpu/text/templates.py; the stage-1 LLM templates are not ported yet)."""

NEGATIVE_PROMPT = (
    "dull, gray, unrealistic, colorless, blurry, low-quality, weird, abrupt"
)
