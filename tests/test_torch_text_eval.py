"""The port's stage-1 text and eval modules against lvd_tpu's on the CPU.

Both packages take the same inputs and must give equal outputs: the parser
and the cache on the cases of tests/test_stage1.py, the inflection helpers on
those of tests/test_words.py and more, the 500 benchmark prompts and every
predicate's verdict on layouts parsed from synthetic responses, NMS, the
layout frames, attention post-processing, the BPE learner and the LLM
client's payloads (through an injected poster: nothing reaches the
network).
"""

import importlib
import json

import numpy as np
import pytest

PACKAGES = ("lvd_tpu", "lvd_tpu_torch")


def both(module):
    """(lvd_tpu's module, the port's module) of a dotted name under each."""
    return tuple(importlib.import_module(f"{p}.{module}") for p in PACKAGES)


SAMPLE_RESPONSE = (
    "Reasoning: the car moves to the right.\n"
    + "\n".join(f"Frame {i + 1}: [{{'id': 0, 'name': 'car', 'box': [{50 + 50 * i}, 220, 100, 60]}}]"
                for i in range(6))
    + "\nBackground keyword: street"
)


def _parse_complete(parser, cache_mod, tmp_path):
    parsed, rec = parser.parse_layout_response("a car", response=SAMPLE_RESPONSE)
    return parsed, rec, parser.parse_layout_response("a car", response=rec)


def _parse_markdown(parser, cache_mod, tmp_path):
    noisy = SAMPLE_RESPONSE.replace(
        "Frame 2: [{'id': 0, 'name': 'car', 'box': [100, 220, 100, 60]}]",
        "Frame 2: - [{'id': 0, 'name': 'car', 'box': [100, 220, 100, 60]}] - the car moved")
    return parser.parse_layout_response("a car", response="```\n" + noisy + "\n```")


def _parse_partial(parser, cache_mod, tmp_path):
    first = "\n".join(SAMPLE_RESPONSE.split("\n")[:4])
    calls = []

    def fetch(suffix):
        calls.append(suffix)
        return first if len(calls) == 1 else "Frame 3:" + SAMPLE_RESPONSE.split("Frame 3:", 1)[1]

    out = parser.parse_layout_response("a car", fetch=fetch, max_partial_response_retries=3)
    return out, calls


def _parse_garbage(parser, cache_mod, tmp_path):
    bad = ("Frame 1: not a list\nFrame 2: []\nFrame 3: []\nFrame 4: []\nFrame 5: []"
           "\nFrame 6: []\nBackground keyword: sky")
    with pytest.raises(parser.LayoutParseError) as err:
        parser.parse_layout_response("x", response=bad)
    retries = []
    with pytest.raises(parser.LayoutParseError) as err2:
        parser.parse_layout_response("x", fetch=lambda s: retries.append(s) or "nothing",
                                     max_partial_response_retries=2)
    return str(err.value), str(err2.value), retries


def _parse_json(parser, cache_mod, tmp_path):
    layout = {"Reasoning": "r", "Background keyword": "room",
              **{f"Frame {i}": [{"id": 0, "name": "cat", "box": [0, 0, 10, 10]}]
                 for i in range(1, 7)}}
    loose = "Response: {'Frame 1': [{'id': 0, 'name': 'cat', 'box': [0, 0, 1, 1]}],}"
    return (parser.parse_layout_response_json("a cat", response=json.dumps(layout)),
            parser.get_parsed_layout("a cat", response=loose.replace(",}", "}"),
                                     json_template=True))


def _cache_multivalue(parser, cache_mod, tmp_path):
    path = str(tmp_path / "cache.json")
    cache = cache_mod.ResponseCache(path)
    cache.load()
    out = [cache.get("p"), cache.add("p", "r1"), cache.add("p", "r2")]
    cache2 = cache_mod.ResponseCache(path)
    cache2.load()
    out += [cache2.get("p"), cache2.get("p"), cache2.get("p"), cache2.values_accessed(),
            "p" in cache2, len(cache2)]
    cache2.reset_access()
    out += [cache2.get("p"), open(path).read()]
    return out


def _with_cache(parser, cache_mod, tmp_path):
    cache = cache_mod.ResponseCache(str(tmp_path / "c.json"))
    cache.load()
    fetches = []
    parsed = parser.get_parsed_layout_with_cache(
        "a car", cache, fetch=lambda s: fetches.append(s) or SAMPLE_RESPONSE)
    cache.reset_access()
    again = parser.get_parsed_layout_with_cache("a car", cache, fetch=None)
    with pytest.raises(KeyError):
        parser.get_parsed_layout_with_cache("a cat", cache, cache_miss_allowed=False)
    return parsed, again, fetches, open(tmp_path / "c.json").read()


STAGE1_CASES = {f.__name__[1:]: f for f in (
    _parse_complete, _parse_markdown, _parse_partial, _parse_garbage, _parse_json,
    _cache_multivalue, _with_cache)}


@pytest.mark.parametrize("case", list(STAGE1_CASES))
def test_stage1_cases_match(case, tmp_path):
    outs = []
    for i, (parser, cache_mod) in enumerate(zip(both("text.parser"), both("text.cache"))):
        (tmp_path / str(i)).mkdir()
        outs.append(STAGE1_CASES[case](parser, cache_mod, tmp_path / str(i)))
    assert outs[0] == outs[1]


def test_words_match():
    ref, got = both("utils.words")
    for n in range(100):
        assert got.number_to_words(n) == ref.number_to_words(n)
    for bad in (-1, 100):
        with pytest.raises(ValueError):
            got.number_to_words(bad)
    phrases = ["car", "moving ball", "lively cat", "box", "butterfly", "person", "wolf", "bus",
               "church", "day", "tomato", "photo", "sheep", "knife", "cars", "boxes",
               "butterflies", "people", "glass", "wolves", "red car", "orange ball", "apple",
               "hour", "user", "unicorn", "european city", "one dog", "umbrella", "Elephant"]
    for p in phrases:
        assert (got.plural(p), got.singular_noun(p), got.a(p)) == \
            (ref.plural(p), ref.singular_noun(p), ref.a(p)), p


def test_templates_match():
    ref, got = both("text.templates")
    for name in ("LAYOUT_CANVAS", "NUM_LAYOUT_FRAMES", "TEMPLATES", "TEMPLATE_VERSIONS",
                 "REQUIRED_LINES", "REQUIRED_LINES_AST", "STOP", "NEGATIVE_PROMPT",
                 "PROMPTS_DEMO", "PROMPT_TYPES"):
        assert getattr(got, name) == getattr(ref, name), name
    for p in (" A bear walks. ", "x.", "a.b.."):
        assert got.canonical_prompt(p) == ref.canonical_prompt(p)
    for t in ("demo", "lvd", "lvd_numeracy", "lvd_sequential"):
        assert got.get_prompts(t) == ref.get_prompts(t)
    assert got.get_num_parsed_layout_frames("v0.1") == ref.get_num_parsed_layout_frames("v0.1")


def _response(objs):
    """A six-frame layout response (512 x 512 canvas) of objects given as
    (name, three (x, y) waypoints at frames 0, 3 and 5, (w, h), frames where
    it is absent)."""
    lines = []
    for f in range(6):
        items = []
        for i, (name, (p0, p1, p2), size, absent) in enumerate(objs):
            if f in absent:
                continue
            a, b, t = (p0, p1, f / 3) if f <= 3 else (p1, p2, (f - 3) / 2)
            xy = [int((1 - t) * a[j] + t * b[j]) for j in range(2)]
            items.append({"id": i, "name": name, "box": [*xy, int(size[0]), int(size[1])]})
        lines.append(f"Frame {f + 1}: {items}")
    return "Reasoning: r.\n" + "\n".join(lines) + "\nBackground keyword: street"


def _random_responses(n=24, seed=0):
    """Responses over the benchmark's objects: 1-3 objects with and without
    colours, moving through random waypoints, some absent from some frames;
    then the two coloured objects of the first attribution prompts, and one
    object through the quadrants of a sequential prompt for each class."""
    rng = np.random.default_rng(seed)
    names = ["car", "cat", "bird", "ball", "dog", "moving car", "walking dog", "red car",
             "blue ball", "white cat", "green bird", "brown dog", "car 1", "dog 2"]
    out = []
    for _ in range(n):
        out.append(_response([
            (str(rng.choice(names)), rng.integers(0, 400, (3, 2)), rng.integers(40, 130, 2),
             set(rng.choice(6, rng.integers(0, 4), replace=False).tolist()))
            for _ in range(rng.integers(1, 4))]))
    from lvd_tpu.eval import benchmark

    for _, pred in benchmark.get_prompt_predicates_attribution(num_prompts=6):
        (name1,), (name2,), mod1, mod2 = pred.args[:4]
        out.append(_response([(f"{mod1} {name1}", [(40, 200)] * 3, (90, 90), set()),
                              (f"{mod2} {name2}", [(300, 200)] * 3, (90, 90), {5})]))
    corner = {"lower left": (60, 330), "lower right": (360, 330), "upper left": (60, 60),
              "upper right": (360, 60)}
    for name, triple in zip(benchmark.EVALUATE_CLASSES_NO_ATTRIBUTE, benchmark._WAYPOINT_TRIPLES):
        out.append(_response([(name, [corner[q] for q in triple], (90, 90), set())]))
    return out


def test_benchmark_prompts_and_verdicts_match():
    """The 500 prompts of the 5 tasks (and every sub-registry) are lvd_tpu's,
    with the same task, OWL-ViT queries and box rule; on every layout parsed
    from the synthetic responses each predicate gives lvd_tpu's verdict."""
    (jbench, tbench), (jharness, tharness) = both("eval.benchmark"), both("eval.harness")
    (jparser, tparser) = both("text.parser")
    ref, got = jbench.get_lvd_full_prompt_predicates(), tbench.get_lvd_full_prompt_predicates()
    assert list(got) == list(ref)
    for name in ref:
        assert [(p, f.type, list(f.texts), f.one_box_per_class) for p, f in got[name]] == \
            [(p, f.type, list(f.texts), f.one_box_per_class) for p, f in ref[name]], name
    assert len(got["lvd"]) == 500
    assert tbench.get_lvd_full_prompts("lvd") == jbench.get_lvd_full_prompts("lvd")
    verdicts = set()
    for resp in _random_responses():
        layout_j, _ = jparser.parse_layout_response("p", response=resp)
        layout_t, _ = tparser.parse_layout_response("p", response=resp)
        assert layout_t == layout_j
        for (_, fj), (_, ft) in zip(ref["lvd"], got["lvd"]):
            want = jharness.evaluate_with_layout(layout_j, fj, 6, 512, 512)
            assert tharness.evaluate_with_layout(layout_t, ft, 6, 512, 512) == want
            verdicts.add(want)
    tasks = {f.type for _, f in ref["lvd"]}
    assert verdicts == {(t, ok) for t in tasks for ok in (True, False)}


def test_nms_matches():
    ref, got = both("eval.nms")
    rng = np.random.default_rng(1)
    for n, pixels in ((0, False), (1, False), (12, False), (30, True)):
        xy = rng.random((n, 2)) * (100 if pixels else 0.7)
        boxes = np.concatenate([xy, xy + rng.random((n, 2)) * (60 if pixels else 0.3)], 1)
        scores, labels = rng.random(n), rng.integers(0, 3, n)
        for fn in ("nms", "class_aware_nms"):
            for thr in (0.3, 0.5):
                a = getattr(ref, fn)(boxes, scores, labels, thr, input_in_pixels=pixels)
                b = getattr(got, fn)(boxes, scores, labels, thr, input_in_pixels=pixels)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
    for box in ([0.1, 0.2, 0.5, 0.9], [0.0, 0.0, 1.0, 1.0], [0.333, 0.25, 0.5, 0.751]):
        for rounding in (True, False):
            assert got.to_gen_box_format(box, 576, 320, rounding) == \
                ref.to_gen_box_format(box, 576, 320, rounding)


def test_layout_frames_match():
    """``render_layout_frames`` is pixel-equal to lvd_tpu's, absent boxes
    and all."""
    (jcond, tcond), (jvis, tvis) = both("layout.condition"), both("utils.vis")
    (jparser,) = both("text.parser")[:1]
    for resp in _random_responses(4, seed=2):
        layout, _ = jparser.parse_layout_response("p", response=resp)
        cj = jcond.parsed_layout_to_condition(layout, height=512, width=512)
        ct = tcond.parsed_layout_to_condition(layout, height=512, width=512)
        for size, n in ((256, None), (64, 3)):
            want = jvis.render_layout_frames(cj, size=size, num_frames=n)
            got = tvis.render_layout_frames(ct, size=size, num_frames=n)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_attn_post_matches():
    ref, got = both("utils.attn_post")
    rng = np.random.default_rng(0)
    key = ("down", 1, 0, 0)
    auxs = [{key: rng.random((4, 2, 6 * 8, 16)).astype(np.float32)} for _ in range(3)]
    for avg_t in (True, False):
        for avg_h in (True, False):
            np.testing.assert_array_equal(
                got.get_token_attn(auxs, key, 3, (6, 8), avg_t, avg_h),
                ref.get_token_attn(auxs, key, 3, (6, 8), avg_t, avg_h))
    m = rng.random((2, 5, 7))
    for dx, dy in ((0, 0), (2, 1), (-3, 2), (1, -4), (7, 0), (0, -5)):
        np.testing.assert_array_equal(got.shift_attn_map(m, dx, dy), ref.shift_attn_map(m, dx, dy))
        for a, b in zip(got.shift_saved_attns(auxs, key, (6, 8), dx, dy),
                        ref.shift_saved_attns(auxs, key, (6, 8), dx, dy)):
            np.testing.assert_array_equal(a, b)


def test_bpe_learner_matches(tmp_path):
    """``learn_bpe`` on a small corpus gives lvd_tpu's merges and vocab; the
    port's ``write_assets`` reproduces its committed assets byte for byte."""
    import pathlib

    ref, got = both("text.make_vocab")
    corpus = ["A red car drives past a blue car.", "Two dogs, one cat!", "naïve café",
              "the the the then there", "A realistic lively video of a scene"]
    for merges in (5, 40, 500):
        m = got.learn_bpe(corpus, num_merges=merges)
        assert m == ref.learn_bpe(corpus, num_merges=merges)
        assert got.build_vocab(m) == ref.build_vocab(m)
    assert got.corpus_texts() == ref.corpus_texts()
    vocab, merges, _, _ = got.write_assets(str(tmp_path))
    assets = pathlib.Path(got.ASSETS_DIR)
    assert pathlib.Path(vocab).read_bytes() == (assets / "vocab.json").read_bytes()
    assert pathlib.Path(merges).read_bytes() == (assets / "merges.txt").read_bytes()


def test_llm_client_payloads_match(monkeypatch):
    ref, got = both("text.client")
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    monkeypatch.setenv("OPENAI_API_BASE", "http://localhost:9/v1")
    monkeypatch.setenv("LVD_LOCAL_LLM_API", "http://localhost:8/v1")
    assert got.MODEL_NAMES == ref.MODEL_NAMES
    template = got.TEMPLATES["v0.1"]
    for prompt, suffix in (("a cat", None), ("a dog", "\nFrame 3:"), ("x", "")):
        assert got.get_full_prompt(template, prompt, suffix) == \
            ref.get_full_prompt(template, prompt, suffix)
        assert got.get_full_prompt("Q: {prompt}", prompt, suffix) == \
            ref.get_full_prompt("Q: {prompt}", prompt, suffix)
        for tpl in (template, "Q: {prompt}"):
            assert got.get_full_chat_prompt(tpl, prompt, suffix) == \
                ref.get_full_chat_prompt(tpl, prompt, suffix)
    for model in got.MODEL_NAMES:
        name_g, cfg_g = got.get_llm_kwargs(model, "v0.1")
        name_r, cfg_r = ref.get_llm_kwargs(model, "v0.1")
        assert (name_g, cfg_g.api_base, cfg_g.headers, cfg_g.is_chat, cfg_g.max_tokens,
                cfg_g.temperature, cfg_g.stop, cfg_g.template) == \
            (name_r, cfg_r.api_base, cfg_r.headers, cfg_r.is_chat, cfg_r.max_tokens,
             cfg_r.temperature, cfg_r.stop, cfg_r.template)

        def poster(log):
            def post(url, payload, headers):
                log.append((url, payload, headers))
                if len(log) == 1:
                    raise OSError("refused")  # one failed request, then an answer
                return {"choices": [{"message": {"content": "chat"}, "text": "completion"}]}
            return post

        calls = []
        for client, log in ((ref, []), (got, [])):
            _, cfg = client.get_llm_kwargs(model, "v0.1")
            fetch = client.make_fetch(cfg, "a cat", _post=poster(log), backoff_seconds=0.0)
            calls.append((fetch(None), fetch("\nFrame 2:"), log))
        assert calls[0] == calls[1]
