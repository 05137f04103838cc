"""Stage-1 prompt templates and the layout-response line protocol.

A copy of lvd_tpu/text/templates.py; parity target of both: the reference's
prompt.py (template registry `templates`,
`required_lines`, `required_lines_ast`, `stop`, `negative_prompt`,
`get_prompts`, `get_num_parsed_layout_frames`). The response *format* is kept
bit-identical to the reference protocol — six ``Frame k:`` lines each holding
a Python-literal list of ``{'id', 'name', 'box'}`` dicts in 512x512 pixel
coordinates plus one ``Background keyword:`` line — so that the shipped
response caches parse identically. The few-shot examples themselves are this
framework's own.
"""

from __future__ import annotations

LAYOUT_CANVAS = (512, 512)  # (height, width) the LLM lays boxes out on
NUM_LAYOUT_FRAMES = 6

_SYSTEM_INSTRUCTIONS = """\
You are an intelligent bounding box generator for videos. You do not generate \
video pixels; you plan object layouts. Given a caption describing a video of \
six frames (two frames per second), output one line per frame listing realistic \
bounding boxes for every object named in the caption, followed by a background \
keyword. Frames are 512x512 pixels with [0, 0] at the top-left corner and \
[512, 512] at the bottom-right corner. Boxes must stay inside the frame and \
should not overlap.

Write each frame as `[{'id': integer object id starting at 0, 'name': object \
name, 'box': [top-left x, top-left y, width, height]}, ...]`. One object per \
box. Keep the same id for the same object in every frame, even if it leaves \
and re-enters the scene. Respect real-world physics (gravity, elasticity) and \
perspective geometry when moving objects between frames. Begin with a short \
reasoning statement of at most a few sentences, then the six frame lines, then \
the background keyword. Follow the example format exactly: no markdown, no \
leading dashes, no comments."""

_FEWSHOT = [
    (
        "A dog running from the right to the left while a kite hovers above",
        """Reasoning: The running dog starts on the right, so its x-coordinate \
decreases steadily while its y-coordinate stays on the ground line. The kite \
hovers above, drifting only slightly around a high position.
Frame 1: [{'id': 0, 'name': 'running dog', 'box': [362, 300, 150, 120]}, {'id': 1, 'name': 'kite', 'box': [200, 60, 90, 60]}]
Frame 2: [{'id': 0, 'name': 'running dog', 'box': [292, 300, 150, 120]}, {'id': 1, 'name': 'kite', 'box': [208, 55, 90, 60]}]
Frame 3: [{'id': 0, 'name': 'running dog', 'box': [222, 300, 150, 120]}, {'id': 1, 'name': 'kite', 'box': [214, 52, 90, 60]}]
Frame 4: [{'id': 0, 'name': 'running dog', 'box': [152, 300, 150, 120]}, {'id': 1, 'name': 'kite', 'box': [208, 56, 90, 60]}]
Frame 5: [{'id': 0, 'name': 'running dog', 'box': [82, 300, 150, 120]}, {'id': 1, 'name': 'kite', 'box': [202, 60, 90, 60]}]
Frame 6: [{'id': 0, 'name': 'running dog', 'box': [12, 300, 150, 120]}, {'id': 1, 'name': 'kite', 'box': [198, 63, 90, 60]}]
Background keyword: park""",
    ),
    (
        "An apple drops from a tree branch in an orchard",
        """Reasoning: The apple starts high on the branch and falls under \
gravity, so its y-coordinate increases with growing speed between frames, \
then it rests on the ground in the final frames.
Frame 1: [{'id': 0, 'name': 'apple', 'box': [240, 80, 40, 40]}]
Frame 2: [{'id': 0, 'name': 'apple', 'box': [240, 110, 40, 40]}]
Frame 3: [{'id': 0, 'name': 'apple', 'box': [240, 180, 40, 40]}]
Frame 4: [{'id': 0, 'name': 'apple', 'box': [240, 300, 40, 40]}]
Frame 5: [{'id': 0, 'name': 'apple', 'box': [240, 452, 40, 40]}]
Frame 6: [{'id': 0, 'name': 'apple', 'box': [240, 452, 40, 40]}]
Background keyword: orchard""",
    ),
    (
        "The camera zooms in on a lighthouse",
        """Reasoning: Zooming in makes the lighthouse occupy a larger region \
over time, so its box grows around a fixed center due to perspective geometry.
Frame 1: [{'id': 0, 'name': 'lighthouse', 'box': [216, 166, 80, 180]}]
Frame 2: [{'id': 0, 'name': 'lighthouse', 'box': [206, 146, 100, 220]}]
Frame 3: [{'id': 0, 'name': 'lighthouse', 'box': [196, 126, 120, 260]}]
Frame 4: [{'id': 0, 'name': 'lighthouse', 'box': [186, 106, 140, 300]}]
Frame 5: [{'id': 0, 'name': 'lighthouse', 'box': [176, 86, 160, 340]}]
Frame 6: [{'id': 0, 'name': 'lighthouse', 'box': [166, 66, 180, 380]}]
Background keyword: coast""",
    ),
]


def _chat_template():
    msgs = [{"role": "system", "content": _SYSTEM_INSTRUCTIONS}]
    for caption, answer in _FEWSHOT:
        msgs.append({"role": "user", "content": f"Caption: {caption}"})
        msgs.append({"role": "assistant", "content": answer})
    return msgs


TEMPLATES = {
    # Version key kept as "v0.1" so CLIs accept the same flag values and the
    # shipped caches (generated under template v0.1) are addressable.
    "v0.1": _chat_template(),
}

TEMPLATE_VERSIONS = list(TEMPLATES)

# Response line protocol (reference prompt.py:64-70): six literal-python frame
# lines then a free-text background keyword line.
REQUIRED_LINES = tuple(f"Frame {i + 1}:" for i in range(NUM_LAYOUT_FRAMES)) + (
    "Background keyword:",
)
REQUIRED_LINES_AST = (True,) * NUM_LAYOUT_FRAMES + (False,)

STOP = "\n\n"

NEGATIVE_PROMPT = (
    "dull, gray, unrealistic, colorless, blurry, low-quality, weird, abrupt"
)

PROMPTS_DEMO = ["A bear walks from the left to the right"]

PROMPT_TYPES = ["demo", "lvd"]


def canonical_prompt(prompt: str) -> str:
    """Canonical prompt form used as the LLM-cache key and for querying
    (reference generate.py:270, prompt_batch.py:88: strip + drop trailing '.')."""
    return prompt.strip().rstrip(".")


def get_num_parsed_layout_frames(template_version: str) -> int:
    return NUM_LAYOUT_FRAMES


def get_prompts(prompt_type: str, return_predicates: bool = False):
    """Prompt-set registry (reference prompt.py:83-99)."""
    if prompt_type.startswith("lvd"):
        from ..eval import benchmark

        if return_predicates:
            return benchmark.get_lvd_full_prompt_predicates(prompt_type)
        return benchmark.get_lvd_full_prompts(prompt_type)
    if prompt_type == "demo":
        if return_predicates:
            raise ValueError("Predicates are not available for demo prompts")
        return list(PROMPTS_DEMO)
    raise ValueError(f"Unknown prompt type: {prompt_type}")
