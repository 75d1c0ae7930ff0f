"""A ``_tl`` model's time and location coords through the port's serving
path, on the CPU, against a plain reference written here: the same weights
in a model built without the coords encoders, with the published sincos
embeddings (Prithvi-EO-2.0's TL encoders: half the width each for year and
day of year, and for latitude and longitude; omega = 1/10000^(2i/d); times
the learned scale), computed in float64 numpy, added to its patch tokens.

The model is a test-only ``_tl`` variant at ``prithvi_eo_tiny``'s widths
(D 256, 4 heads, 2 blocks), with the 600M's patch 14 and k5/k7 head, T=2,
56 px, its weights drawn from a seed (the scales at 0.5, away from their
init) and its BatchNorm statistics taken over chips with coords (with
statistics at their init the head's ReLUs pass little that depends on the
tokens).

* ``PrithviSeg`` with coords and the fused predict with raw uint16 chips and
  host coords equal the reference: in float32 (the "xla" attention route)
  logits within 1e-4 of the logits' scale and every pixel's class within a
  gap of 1e-3 of the reference's best; in bf16 (the kernel route's plain
  version) logits within 3e-2 relative and at most 1% of pixels' classes
  beyond a gap of 0.12 of the logits' spread.
* Without coords the ``_tl`` model's output equals, bit for bit, that of
  the same weights in a model built without the coords encoders (what a
  ``_tl`` model served before its predict took coords), and each forward
  counts ``coords_missing``; with them, ``coord_embeds``.
* The coords move the logits; the embeddings are float32 in a bf16 model
  and keep year-sized phases (within 1e-4 of a float64 computation).
* Coords on another device than the model's raise (no copy inside the
  encoder). The fused predict logs its warning once, and checks the
  coords' shapes; ``ModelServer.uses_coords`` names a ``_tl`` model.
"""

import logging

import numpy as np
import pytest
import torch

from instageo_tpu_torch.models import prithvi, registry
from instageo_tpu_torch.models.seg import create_prithvi_seg
from instageo_tpu_torch.ops import preprocess as pp

T, SIZE, RAW, CLASSES, D = 2, 56, 60, 5, 256
# HLS band statistics (the multi-temporal crop task's).
MEAN = [494.905781, 815.239594, 924.335066, 2968.881459, 2634.621962, 1739.579917]
STD = [284.925432, 357.84876, 575.566823, 896.601013, 951.900334, 921.407808]
SCALE = 0.5


@pytest.fixture
def variants(monkeypatch):
    """``tiny_tl`` and its twin without the coords encoders."""
    base = registry.PRITHVI_ARCHS["prithvi_eo_tiny"].replace(
        num_frames=T, patch_size=(1, 14, 14), depth=2)
    for name, arch in (("tiny_tl", base.replace(coords_encoding=("time", "location"),
                                                 coords_scale_learn=True)),
                       ("tiny_no_tl", base)):
        monkeypatch.setitem(registry.PRITHVI_ARCHS, name, arch)
        monkeypatch.setitem(registry.SEG_HEAD_KERNEL_SIZES, name, (5, 5, 5, 7))


def _sincos(d, values):
    """float64 (N, d) sin | cos of ``values`` (N,) at omega = 1/10000^(2i/d)."""
    omega = 1.0 / 10000 ** (np.arange(d // 2) / (d / 2.0))
    out = np.asarray(values, np.float64).reshape(-1)[:, None] * omega
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def _embedding(temporal, location, tokens_per_frame):
    """The coords' embedding of every patch token, (B, T·h·w, D) float64:
    a frame's year | day-of-year row on each of its tokens, plus the chip's
    latitude | longitude row, each times ``SCALE``."""
    b, t, _ = temporal.shape
    frames = np.concatenate([_sincos(D // 2, temporal[..., 0]),
                             _sincos(D // 2, temporal[..., 1])], axis=1).reshape(b, t, D)
    place = np.concatenate([_sincos(D // 2, location[:, 0]),
                            _sincos(D // 2, location[:, 1])], axis=1)
    return SCALE * (np.repeat(frames, tokens_per_frame, axis=1) + place[:, None])


def _reference(weights, x, temporal, location, dtype):
    """Logits of the model without the coords encoders, the embedding added
    to its patch tokens in float32 and cast to their dtype."""
    plain = _model("tiny_no_tl", dtype, weights)
    emb = torch.from_numpy(_embedding(temporal, location, (SIZE // 14) ** 2)).float()
    hook = plain.prithvi_encoder.patch_embed.register_forward_hook(
        lambda module, args, out: out + emb.to(out.dtype))
    with torch.no_grad():
        logits = plain(x)
    hook.remove()
    return logits


def _weights(seed=3):
    """The ``_tl`` model's state from ``seed``, the scales at ``SCALE``, and
    each BatchNorm's statistics, in order, those of its input in float32
    over chips with coords."""
    torch.manual_seed(seed)
    model = _model("tiny_tl", torch.float32)
    enc = model.prithvi_encoder
    with torch.no_grad():
        enc.temporal_embed_enc.scale.fill_(SCALE)
        enc.location_embed_enc.scale.fill_(SCALE)
    raw, temporal, location = _inputs(b=4, seed=seed + 100)
    x, tc, lc = _chips(raw), torch.from_numpy(temporal), torch.from_numpy(location)
    for bn in [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]:
        seen = []
        hook = bn.register_forward_pre_hook(lambda module, args: seen.append(args[0].float()))
        with torch.no_grad():
            model(x, temporal_coords=tc, location_coords=lc)
        hook.remove()
        bn.running_mean.copy_(seen[0].mean(dim=(0, 2, 3)))
        bn.running_var.copy_(seen[0].var(dim=(0, 2, 3), unbiased=False))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _model(variant, dtype, weights=None):
    model = create_prithvi_seg(variant, num_classes=CLASSES, temporal_step=T,
                               image_size=SIZE, num_bands=6, dtype=dtype, device="cpu",
                               attn_impl="xla" if dtype == torch.float32 else "kernel")
    if weights is not None:
        state = {k: v for k, v in weights.items() if k in model.state_dict()}
        model.load_state_dict(state, strict=True)
    return model.eval()


def _chips(raw):
    """Raw uint16 chips preprocessed as the fused predict does, float32."""
    return pp.preprocess_chips(pp.raw_to_device(raw, torch.device("cpu")), torch.tensor(MEAN),
                               torch.tensor(STD), temporal_size=T, img_size=SIZE)


def _inputs(b=3, seed=4):
    rng = np.random.default_rng(seed)
    raw = np.clip(rng.normal(np.tile(MEAN, T)[:, None, None], np.tile(STD, T)[:, None, None],
                             (b, 6 * T, RAW, RAW)), 0, 10000).round().astype(np.uint16)
    years = rng.integers(2018, 2024, (b, 1)).repeat(T, axis=1)
    days = np.sort(rng.choice(np.arange(60, 301), (b, T), replace=False), axis=1)
    temporal = np.stack([years, days], axis=-1).astype(np.float32)
    location = np.stack([rng.uniform(25, 49, b), rng.uniform(-125, -67, b)],
                        axis=1).astype(np.float32)
    return raw, temporal, location


def _gaps(ref_logits, classes):
    """Each pixel's gap below the reference's best logit, in units of the
    logits' spread over the classes (the benchmark's ``check.GapStats``)."""
    spread = (ref_logits - ref_logits.mean(dim=1, keepdim=True)).square().mean().sqrt()
    got = ref_logits.gather(1, classes.long()[:, None])[:, 0]
    return (ref_logits.amax(dim=1) - got) / spread


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_port_equals_the_reference(variants, dtype):
    w = _weights()
    model = _model("tiny_tl", dtype, w)
    raw, temporal, location = _inputs()
    tc, lc = torch.from_numpy(temporal), torch.from_numpy(location)
    x = _chips(raw)
    want = _reference(w, x, temporal, location, torch.float32)
    with torch.no_grad():
        got = model(x, temporal_coords=tc, location_coords=lc)
    scale = want.abs().max()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(scale))
    else:
        assert float((got - want).norm() / want.norm()) <= 3e-2
    predict = pp.make_fused_predict_fn(model, MEAN, STD, temporal_size=T, img_size=SIZE)
    classes = predict(raw, temporal, location)
    assert classes.dtype == torch.int8 and classes.shape == want.argmax(dim=1).shape
    gaps = _gaps(want, classes)
    if dtype == torch.float32:
        assert float(gaps.max()) <= 1e-3
    else:
        assert float((gaps > 0.12).float().mean()) <= 0.01


def test_without_coords_is_the_model_without_encoders(variants):
    w = _weights()
    tl, plain = _model("tiny_tl", torch.bfloat16, w), _model("tiny_no_tl", torch.bfloat16, w)
    raw, temporal, location = _inputs(seed=5)
    x = _chips(raw)
    embeds, missing = prithvi.coord_embeds.count, prithvi.coords_missing.count
    with torch.no_grad():
        bare = tl(x)
        assert torch.equal(bare, plain(x))
        assert (prithvi.coord_embeds.count, prithvi.coords_missing.count) == (embeds,
                                                                            missing + 1)
        coords = tl(x, temporal_coords=torch.from_numpy(temporal),
                    location_coords=torch.from_numpy(location))
    assert (prithvi.coord_embeds.count, prithvi.coords_missing.count) == (embeds + 1,
                                                                        missing + 1)
    spread = (bare - bare.mean(dim=1, keepdim=True)).square().mean().sqrt()
    assert float((coords - bare).abs().max()) > 0.5 * float(spread)
    got = pp.make_fused_predict_fn(tl, MEAN, STD, temporal_size=T, img_size=SIZE)(raw)
    want = pp.make_fused_predict_fn(plain, MEAN, STD, temporal_size=T, img_size=SIZE)(raw)
    assert torch.equal(got, want)
    assert prithvi.coords_missing.count == missing + 2
    # A model without the encoders takes coords and adds nothing, uncounted.
    with torch.no_grad():
        assert torch.equal(plain(x, temporal_coords=torch.from_numpy(temporal),
                                 location_coords=torch.from_numpy(location)), bare)
    assert prithvi.coords_missing.count == missing + 2


def test_embeddings_are_float32_in_a_bf16_model(variants):
    model = _model("tiny_tl", torch.bfloat16, _weights())
    enc = model.prithvi_encoder
    tc = torch.tensor([[[2023.0, 300.0], [2023.0, 301.0]]])
    lc = torch.tensor([[48.5, -124.5]])
    assert enc.temporal_embed_enc.scale.dtype == torch.float32
    t_emb, l_emb = enc.temporal_embed_enc(tc), enc.location_embed_enc(lc)
    assert t_emb.dtype == l_emb.dtype == torch.float32
    want = SCALE * np.concatenate([_sincos(D // 2, [2023.0]), _sincos(D // 2, [301.0])],
                                  axis=1)[0]
    np.testing.assert_allclose(t_emb[0, 1].detach().numpy(), want, rtol=0, atol=1e-4)


def test_coords_on_another_device_raise(variants):
    """Coords not on the model's device raise: the encoder copies nothing."""
    model = _model("tiny_tl", torch.float32, _weights())
    raw, temporal, location = _inputs(b=2, seed=7)
    x = _chips(raw)
    tc, lc = torch.from_numpy(temporal), torch.from_numpy(location)
    with torch.no_grad():
        with pytest.raises(ValueError, match="temporal_coords on meta"):
            model(x, temporal_coords=tc.to("meta"), location_coords=lc)
        with pytest.raises(ValueError, match="location_coords on meta"):
            model(x, temporal_coords=tc, location_coords=lc.to("meta"))


def test_predict_warns_once_and_checks_shapes(variants, caplog):
    model = _model("tiny_tl", torch.bfloat16, _weights())
    raw, temporal, location = _inputs(b=2, seed=6)
    predict = pp.make_fused_predict_fn(model, MEAN, STD, temporal_size=T, img_size=SIZE)
    with caplog.at_level(logging.WARNING, logger=pp.__name__):
        predict(raw)
        predict(raw)
        predict(raw, temporal, location)
    assert sum("without coords" in r.getMessage() for r in caplog.records) == 1
    with pytest.raises(ValueError, match="temporal_coords"):
        predict(raw, temporal[:, :1], location)
    with pytest.raises(ValueError, match="location_coords"):
        predict(raw, temporal, location[:1])


def test_model_server_names_a_tl_model(variants):
    from instageo_tpu_torch.configs.config import load_config
    from instageo_tpu_torch.serve.server import ModelServer

    flags = {}
    for variant in ("tiny_tl", "tiny_no_tl"):
        cfg = load_config("config", overrides={
            "device": "cpu", "model.model_name": variant, "model.num_classes": CLASSES,
            "model.load_pretrained_weights": False, "dataloader.img_size": SIZE,
            "dataloader.bands": list(range(6 * T)), "dataloader.mean": MEAN,
            "dataloader.std": STD, "dataloader.temporal_dim": T})
        flags[variant] = ModelServer(cfg).uses_coords
    assert flags == {"tiny_tl": True, "tiny_no_tl": False}
