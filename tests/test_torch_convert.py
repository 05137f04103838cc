"""The port's checkpoint converter against lvd_tpu's on the CPU.

HF-keyed, torch-layout state dicts are built from tiny trees as
tests/test_convert.py builds them (its inverse key maps and transposes),
here from the port's draws of lvd_tpu's tiny trees (UNet3D default and
gated, CLIP with its projection, VAE, and the upsample CLI's tiny SDXL
UNet2D), so nothing of lvd_tpu's init is compiled. Both converters must
give trees equal bit for bit (and equal to the source); the npz files each
package writes load through the other's loader, ``convert_checkpoint``
included; ``verify_conversion`` catches an unconsumed tensor and a lost
weight in both; ``check_sdxl_unet_config`` accepts and rejects as
lvd_tpu's does; ``validate_against_init`` passes on the port's shape walks
and names what a wrong tree lacks.
"""

import json

import numpy as np
import pytest
import torch

from lvd_tpu.models import convert as j_conv
from lvd_tpu_torch import config as tcfg
from lvd_tpu_torch.models import convert as t_conv
from lvd_tpu_torch.utils import prng
from test_convert import _synthesize, _torch_key_clip, _torch_key_unet, _torch_key_vae


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module's CPU draws: the suite runs six
    workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.numpy()


def _clip_key(path):
    return "text_projection.weight" if path.startswith("text_projection") else _torch_key_clip(path)


def _case(name):
    """(source tree as numpy, HF state dict, port converter call, lvd_tpu
    converter call, the port's shape walk)."""
    from lvd_tpu import config as jcfg
    from lvd_tpu.models import unet2d as j_u2
    from lvd_tpu_torch.cli.upsample import tiny_sdxl_configs
    from lvd_tpu_torch.models import clip, unet2d, unet3d, vae

    key = prng.fold_in(prng.prng_key(2), 7)
    if name.startswith("unet3d"):
        kind = "gated" if name.endswith("gated") else "default"
        cfg, jc = tcfg.tiny_unet_config(kind), jcfg.tiny_unet_config(kind)
        walk = unet3d.unet3d_leaves(key, cfg)
        keyfn = _torch_key_unet
        calls = (lambda sd: t_conv.convert_unet3d(sd, cfg), lambda sd: j_conv.convert_unet3d(sd, jc))
    elif name == "clip":
        cfg, jc = tcfg.tiny_clip_config(), jcfg.tiny_clip_config()
        walk = clip.clip_text_leaves(key, cfg, with_projection=True)
        keyfn = _clip_key
        calls = (lambda sd: t_conv.convert_clip_text(sd, cfg),
                 lambda sd: j_conv.convert_clip_text(sd, jc))
    elif name == "vae":
        cfg, jc = tcfg.tiny_vae_config(), jcfg.tiny_vae_config()
        walk = vae.vae_leaves(key, cfg)
        keyfn = _torch_key_vae
        calls = (lambda sd: t_conv.convert_vae(sd, cfg), lambda sd: j_conv.convert_vae(sd, jc))
    else:
        import dataclasses

        cfg = tiny_sdxl_configs()[0]
        jc = j_u2.UNet2DConfig(**dataclasses.asdict(cfg))
        walk = unet2d.unet2d_leaves(key, cfg)
        keyfn = _torch_key_unet
        calls = (lambda sd: t_conv.convert_unet2d(sd, cfg),
                 lambda sd: j_conv.convert_unet2d(sd, jc))
    from lvd_tpu_torch.models import init

    tree = _np(init.draw(walk, "cpu"))
    sd = _synthesize(t_conv.flatten_tree(tree), keyfn)
    return tree, sd, calls, walk


def _assert_equal(a, b):
    fa, fb = t_conv.flatten_tree(a), t_conv.flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


NAMES = ["unet3d", "unet3d_gated", "clip", "vae", "unet2d_sdxl"]


@pytest.mark.parametrize("name", NAMES)
def test_converter_trees_equal_lvd_tpus(name, tmp_path):
    from lvd_tpu.models.loader import load_params as j_load
    from lvd_tpu.models.loader import save_params as j_save
    from lvd_tpu_torch.models.loader import load_params_npz

    tree, sd, (port, ref), walk = _case(name)
    got, want = port(dict(sd)), ref(dict(sd))
    _assert_equal(got, want)
    _assert_equal(got, tree)
    t_conv.validate_against_init(got, walk, name)
    # Each package's npz through the other's loader.
    t_conv.save_params(str(tmp_path / "port.npz"), got)
    j_save(str(tmp_path / "lvd_tpu.npz"), want)
    _assert_equal(_np_tree(j_load(str(tmp_path / "port.npz"))), want)
    _assert_equal(_np(load_params_npz(str(tmp_path / "lvd_tpu.npz"), "cpu")), got)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "lvd_tpu.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def test_verify_conversion_catches_unconsumed_and_mass():
    tree, sd, (port, ref), _ = _case("clip")
    for conv in (t_conv, j_conv):
        call = port if conv is t_conv else ref
        rec = conv.RecordingStateDict(dict(sd, **{"text_model.embeddings.position_ids":
                                                  np.zeros((1, 77))}))
        conv.verify_conversion(rec, call(rec), "clip")  # position_ids is ignorable
        rec = conv.RecordingStateDict(dict(sd, **{"text_model.encoder.layers.99.bogus.weight":
                                                  np.ones((3, 3))}))
        with pytest.raises(ValueError, match="NOT consumed"):
            conv.verify_conversion(rec, call(rec), "clip")
        rec = conv.RecordingStateDict(dict(sd))
        converted = call(rec)
        converted["layers"][0]["fc1"]["w"] = converted["layers"][0]["fc1"]["w"] * 2.0
        with pytest.raises(ValueError, match="mass not conserved"):
            conv.verify_conversion(rec, converted, "clip")


def test_check_sdxl_unet_config_matches_lvd_tpu():
    from lvd_tpu.models.unet2d import sdxl_refiner_config as j_cfg
    from lvd_tpu_torch.models.unet2d import sdxl_refiner_config

    good = {
        "in_channels": 4, "out_channels": 4, "block_out_channels": [384, 768, 1536, 1536],
        "layers_per_block": 2, "cross_attention_dim": 1280, "norm_num_groups": 32,
        "attention_head_dim": [6, 12, 24, 24],
        "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                             "DownBlock2D"],
        "transformer_layers_per_block": 4, "addition_embed_type": "text_time",
        "addition_time_embed_dim": 256, "projection_class_embeddings_input_dim": 2560,
    }
    cases = [good, dict(good, block_out_channels=[320, 640, 1280], cross_attention_dim=2048),
             dict(good, attention_head_dim=[5, 10, 20, 20]),
             dict(good, down_block_types=["CrossAttnDownBlock2D"] * 4),
             dict(good, transformer_layers_per_block=[0, 2, 2, 0]),
             {k: v for k, v in good.items() if k != "attention_head_dim"}]
    for hf in cases:
        outcomes = []
        for conv, cfg in ((t_conv, sdxl_refiner_config()), (j_conv, j_cfg())):
            try:
                conv.check_sdxl_unet_config(hf, cfg)
                outcomes.append(None)
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]
    assert outcomes[0] is None  # the last case lacks a field: nothing to contradict


def test_validate_against_init_names_the_fault():
    from lvd_tpu_torch.models import vae

    walk = vae.vae_leaves(prng.prng_key(0), tcfg.tiny_vae_config())
    tree, _, _, _ = _case("vae")
    t_conv.validate_against_init(tree, walk, "vae")
    del tree["quant_conv"]["b"]
    tree["post_quant_conv"]["w"] = tree["post_quant_conv"]["w"][..., :2]
    with pytest.raises(ValueError, match=r"missing 1.*quant_conv/b.*shape-mismatched 1"):
        t_conv.validate_against_init(tree, walk, "vae")


def _hf_dir(root, tree_sd, configs):
    for sub, sd in tree_sd.items():
        (root / sub).mkdir(parents=True)
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                   root / sub / "pytorch_model.bin")
        with open(root / sub / "config.json", "w") as f:
            json.dump(configs[sub], f)


def test_convert_checkpoint_main_writes_lvd_tpus_files(tmp_path):
    """``main`` on a tiny HF directory (torch .bin weights, config.json
    files): the same files as lvd_tpu's ``convert_checkpoint``, every npz
    equal key for key, and lvd_tpu's loader reads the port's."""
    from lvd_tpu.models.loader import load_params as j_load

    sds = {"unet": _case("unet3d")[1], "text_encoder": _case("clip")[1],
           "vae": _case("vae")[1]}
    configs = {
        "unet": {"block_out_channels": [32, 64, 64, 64], "cross_attention_dim": 64,
                 "attention_head_dim": 16, "norm_num_groups": 8},
        "text_encoder": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                         "num_attention_heads": 4},
        "vae": {"block_out_channels": [16, 32, 32, 32], "norm_num_groups": 8},
    }
    _hf_dir(tmp_path / "hf", sds, configs)
    t_conv.main(["--src", str(tmp_path / "hf"), "--dst", str(tmp_path / "port"),
                 "--no-validate"])
    j_conv.convert_checkpoint(str(tmp_path / "hf"), str(tmp_path / "lvd_tpu"), validate=False)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "lvd_tpu").iterdir())
    assert names == ["clip.npz", "lvd_tpu_config.json", "unet.npz", "vae.npz"]
    for name in ("unet.npz", "clip.npz", "vae.npz"):
        with np.load(tmp_path / "port" / name) as a, np.load(tmp_path / "lvd_tpu" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
        j_load(str(tmp_path / "port" / name))
    with open(tmp_path / "port" / "lvd_tpu_config.json") as a, \
            open(tmp_path / "lvd_tpu" / "lvd_tpu_config.json") as b:
        assert json.load(a) == json.load(b)
