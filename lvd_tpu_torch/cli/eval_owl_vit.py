"""Stage-2 (pixel-level) benchmark evaluation with an OWL-ViT judge
(counterpart of lvd_tpu/cli/eval_owl_vit.py).

Parity target of both: the reference's scripts/eval_owl_vit.py. For each benchmark
prompt: load the generated video, sample N evenly-spaced frames, run open-
vocabulary detection with the predicate's text queries, threshold + NMS
(+ optional one-box-per-class), reconstruct a parsed_layout from the
detections, and score it with the same predicates as stage 1.

The judge model is an offline scorer, not part of the generation path — it
runs via transformers, imported when a judge is made, as in lvd_tpu, on the
card unless ``LVD_PLATFORM=cpu`` (as the reference runs it on CUDA). Weights
load from the HF cache or a local directory (--owl-vit-path). ``eval_prompt`` takes any judge with
lvd_tpu's ``detect(image, texts)``. The videos are the frames files the
runners write (``video_*.joblib``, or ``.npz`` where joblib is absent).
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from glob import glob

import numpy as np

from ..eval.harness import evaluate_with_layout
from ..eval.nms import class_aware_nms, nms, to_gen_box_format
from ..text.templates import canonical_prompt, get_prompts
from ..utils import vis
from ..utils.platform import device as platform_device
from ..utils.platform import maybe_force_platform


def keep_one_box_per_class(boxes, scores, labels):
    """Keep only the highest-scoring box of each label (no tracking in the
    evaluator; only numeracy tolerates duplicate labels)."""
    kept_b, kept_s, kept_l = [], [], []
    for label in np.unique(labels):
        sel = labels == label
        best = scores[sel].argmax()
        kept_b.append(boxes[sel][best])
        kept_s.append(scores[sel][best])
        kept_l.append(label)
    return np.array(kept_b), np.array(kept_s), np.array(kept_l)


class OwlVitJudge:
    """Thin wrapper around transformers OWL-ViT detection, on the device
    ``LVD_PLATFORM`` asks for (the card unless ``cpu``)."""

    def __init__(self, model_path: str = "google/owlvit-base-patch32"):
        import torch
        from transformers import OwlViTForObjectDetection, OwlViTProcessor

        self.torch = torch
        self.device = platform_device()
        self.processor = OwlViTProcessor.from_pretrained(model_path)
        self.model = OwlViTForObjectDetection.from_pretrained(model_path).to(self.device)
        self.model.eval()

    def detect(self, image: np.ndarray, texts):
        """image (H, W, 3) uint8; texts: list of query strings.
        Returns (boxes_xyxy_norm, scores, labels) numpy arrays."""
        torch = self.torch
        h, w = image.shape[:2]
        with torch.no_grad():
            inputs = self.processor(
                text=[texts], images=image, return_tensors="pt"
            ).to(self.device)
            outputs = self.model(**inputs)
            target_sizes = torch.tensor([[h, w]], device=self.device)
            results = self.processor.post_process_object_detection(
                outputs=outputs, target_sizes=target_sizes, threshold=0.0
            )[0]
        boxes = results["boxes"].cpu().numpy()
        boxes = boxes / np.array([w, h, w, h], np.float32)
        return (
            boxes,
            results["scores"].cpu().numpy(),
            results["labels"].cpu().numpy(),
        )


def detections_to_layout_frame(boxes, scores, labels, texts, width, height):
    """Detections -> the parsed_layout object list of one frame (ids encode
    label*100+instance so same-label instances stay distinct)."""
    det_boxes = []
    label_counts: dict = {}
    for box, score, label in zip(boxes, scores, labels):
        label = int(label)
        label_counts.setdefault(label, 0)
        det_boxes.append(
            {
                "id": label * 100 + label_counts[label],
                "name": texts[label],
                "box": to_gen_box_format(box, width, height, rounding=True),
                "score": float(score),
            }
        )
        label_counts[label] += 1
    return det_boxes


def eval_prompt(
    prompt,
    predicate,
    path,
    judge: OwlVitJudge,
    score_threshold=0.1,
    nms_threshold=0.5,
    use_class_aware_nms=False,
    num_eval_frames=6,
    verbose=False,
):
    video = vis.load_video(path)
    if video.dtype != np.uint8:
        video = (np.clip(video, 0, 1) * 255).astype(np.uint8)
    texts = list(predicate.texts)

    frame_indices = (
        np.round(np.linspace(0, len(video) - 1, num_eval_frames)).astype(int).tolist()
    )
    if len(set(frame_indices)) != len(frame_indices):
        raise ValueError(f"Eval frame indices not unique: {frame_indices}")

    height, width = video.shape[1], video.shape[2]
    parsed_layout = {"Prompt": prompt, "Background keyword": None}

    for out_ind, frame_index in enumerate(frame_indices, start=1):
        boxes, scores, labels = judge.detect(video[frame_index], texts)
        keep = scores >= score_threshold
        boxes, scores, labels = boxes[keep], scores[keep], labels[keep]

        if len(boxes):
            nms_fn = class_aware_nms if use_class_aware_nms else nms
            boxes, scores, labels = nms_fn(boxes, scores, labels, nms_threshold)

        if len(boxes) and predicate.one_box_per_class:
            boxes, scores, labels = keep_one_box_per_class(boxes, scores, labels)

        parsed_layout[f"Frame {out_ind}"] = detections_to_layout_frame(
            boxes, scores, labels, texts, width, height
        )

    if verbose:
        print(f"parsed_layout: {parsed_layout}")

    return evaluate_with_layout(
        parsed_layout,
        predicate,
        num_parsed_layout_frames=num_eval_frames,
        height=height,
        width=width,
        verbose=verbose,
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--prompt-type", type=str, default="lvd")
    p.add_argument("--run_base_path", type=str, required=True)
    p.add_argument("--run_start_ind", default=0, type=int)
    p.add_argument("--num_prompts", default=None, type=int)
    p.add_argument("--num_eval_frames", default=6, type=int)
    p.add_argument("--skip_first_prompts", default=0, type=int)
    p.add_argument("--detection_score_threshold", default=0.05, type=float)
    p.add_argument("--nms_threshold", default=0.5, type=float)
    p.add_argument("--class-aware-nms", action="store_true")
    p.add_argument("--save-eval", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--owl-vit-path", default="google/owlvit-base-patch32",
                   help="HF id or local path of the OWL-ViT judge")
    args = p.parse_args(argv)
    maybe_force_platform()

    prompt_predicates = get_prompts(args.prompt_type, return_predicates=True)
    print(f"{len(prompt_predicates)} prompts; {args.num_eval_frames} eval frames")

    judge = OwlVitJudge(args.owl_vit_path)

    success_counts = defaultdict(int)
    all_counts = defaultdict(int)
    successes = defaultdict(list)

    for ind, (prompt, predicate) in enumerate(prompt_predicates):
        prompt = canonical_prompt(prompt)
        if ind < args.skip_first_prompts:
            continue
        if args.num_prompts is not None and ind >= (
            args.skip_first_prompts + args.num_prompts
        ):
            continue

        paths = sorted(
            glob(f"{args.run_base_path}/{ind + args.run_start_ind}/video_*.joblib")
        ) or sorted(
            glob(f"{args.run_base_path}/{ind + args.run_start_ind}/video_*.npz")
        )
        if len(paths) != 1:
            print(f"***Expected exactly one video for ind {ind}, got {len(paths)}; skipping***")
            continue

        eval_type, ok = eval_prompt(
            prompt,
            predicate,
            paths[0],
            judge,
            score_threshold=args.detection_score_threshold,
            nms_threshold=args.nms_threshold,
            use_class_aware_nms=args.class_aware_nms,
            num_eval_frames=args.num_eval_frames,
            verbose=args.verbose,
        )
        success_counts[eval_type] += int(ok)
        all_counts[eval_type] += 1
        successes[eval_type].append(bool(ok))

    summary = []
    total_s = total_c = 0
    for k in sorted(all_counts):
        rate = success_counts[k] / all_counts[k]
        print(f"Eval type: {k}, success: {success_counts[k]}/{all_counts[k]}, "
              f"rate: {rate:.2f}")
        total_s += success_counts[k]
        total_c += all_counts[k]
        summary.append(rate)
    if total_c:
        overall = total_s / total_c
        print(f"Overall: {total_s}/{total_c}, rate: {overall:.2f}")
        summary.append(overall)
        print("Summary:", "/".join(f"{r:.2f}" for r in summary))

    if args.save_eval:
        with open(f"{args.run_base_path}/eval.json", "w") as f:
            json.dump(
                {
                    "success_counts": dict(success_counts),
                    "sample_counts": dict(all_counts),
                    "successes": {k: v for k, v in successes.items()},
                    "success_counts_overall": total_s,
                    "sample_counts_overall": total_c,
                },
                f,
                indent=4,
            )


if __name__ == "__main__":
    main()
