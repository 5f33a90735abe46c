"""Full-size pretrained-weight conversion parity (BASELINE correctness
target: "top-k probabilities within 1e-3", "macro-F1 parity ±0.5%").

Three layers of evidence, all offline (no network):

1. ResNet50: a hand-written torch model with torchvision's EXACT
   state_dict schema (conv1/bn1/layerX.Y.{conv,bn}{1..3}/downsample.{0,1},
   v1.5 stride-on-conv2 semantics, ref `src/cnn_encoder.py:73-86`) is
   random-initialized, converted via `convert_torchvision_resnet50`, and
   the FULL pooled-feature forward must match torch eval() numerics.
2. BERT: a full-size (12-layer, 768-hidden, BioBERT-shaped) random
   `transformers.BertModel` converted via `convert_hf_bert` must
   reproduce last_hidden_state + pooler_output at T=128.
3. End-to-end: a complete multimodal checkpoint assembled from converted
   random torch weights, served through `inference.load_predictor` on a
   real corpus image + clinical description, pinned as a golden file —
   the ±1e-3 contract as a CI assertion.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.slow

GOLDEN = Path(__file__).parent / "golden" / "converted_predictor_probs.json"
REF_IMAGES = Path("/root/reference/data/images")


# ---------------------------------------------------------------------------
# torch ResNet50 with the torchvision state_dict schema
# ---------------------------------------------------------------------------

class _Bottleneck(torch.nn.Module):
    def __init__(self, cin, width, stride=1, downsample=None):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class _TorchResNet50(torch.nn.Module):
    """torchvision.models.resnet50-compatible (keys and semantics)."""

    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        widths, blocks = (64, 128, 256, 512), (3, 4, 6, 3)
        cin = 64
        for i, (w, n) in enumerate(zip(widths, blocks), start=1):
            layers = []
            for b in range(n):
                stride = 2 if (b == 0 and i > 1) else 1
                downsample = None
                if b == 0:
                    downsample = nn.Sequential(
                        nn.Conv2d(cin, w * 4, 1, stride=stride, bias=False),
                        nn.BatchNorm2d(w * 4))
                layers.append(_Bottleneck(cin, w, stride, downsample))
                cin = w * 4
            setattr(self, f"layer{i}", nn.Sequential(*layers))
        self.avgpool = nn.AdaptiveAvgPool2d(1)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in (1, 2, 3, 4):
            x = getattr(self, f"layer{i}")(x)
        return self.avgpool(x).flatten(1)  # [B, 2048] (fc == Identity)


def _randomized_eval_resnet(seed=0):
    torch.manual_seed(seed)
    m = _TorchResNet50()
    # randomize BN running stats too (fresh BN stats are 0/1 — trivial)
    for mod in m.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            with torch.no_grad():
                mod.running_mean.normal_(0, 0.05)
                mod.running_var.uniform_(0.5, 1.5)
    return m.eval()


def test_resnet50_full_forward_parity():
    from multimodal_rare_disease.models.convert import (
        convert_torchvision_resnet50,
    )
    from multimodal_rare_disease.models.resnet import ResNet50Encoder

    m = _randomized_eval_resnet()
    sd = m.state_dict()
    # schema check: exactly the torchvision key set (no fc here)
    assert "layer3.5.conv3.weight" in sd
    assert "layer1.0.downsample.1.running_var" in sd

    params, stats = convert_torchvision_resnet50(sd)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ref = m(torch.tensor(x.transpose(0, 3, 1, 2))).numpy()

    enc = ResNet50Encoder()
    pooled, feats = enc.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=False)
    ours = np.asarray(pooled)
    assert ours.shape == ref.shape == (2, 2048)
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-3)
    # Grad-CAM stage maps exist at the right scales
    assert feats["stage4"].shape == (2, 2, 2, 2048)


def test_hf_bert_fullsize_parity():
    from transformers import BertConfig, BertModel

    from multimodal_rare_disease.models.bert import BertEncoder
    from multimodal_rare_disease.models.convert import convert_hf_bert

    hf_cfg = BertConfig(
        vocab_size=28996, hidden_size=768, num_hidden_layers=12,
        num_attention_heads=12, intermediate_size=3072,
        max_position_embeddings=512, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    torch.manual_seed(0)
    hf = BertModel(hf_cfg).eval()

    T = 128
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 28996, (2, T))
    mask = np.ones((2, T), np.int64)
    mask[0, 100:] = 0
    mask[1, 64:] = 0
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids),
                 attention_mask=torch.tensor(mask))

    params = convert_hf_bert(hf.state_dict(), num_layers=12, num_heads=12)
    enc = BertEncoder(vocab_size=28996, hidden_size=768, num_layers=12,
                      num_heads=12, intermediate_size=3072,
                      max_position_embeddings=512, dropout=0.0)
    out = enc.apply({"params": params}, jnp.asarray(ids, jnp.int32),
                    jnp.asarray(mask, jnp.int32))

    # only real-token positions are contractual (HF computes padded
    # positions too, but downstream consumes CLS/pooled only)
    got_h = np.asarray(out["last_hidden_state"])
    ref_h = ref.last_hidden_state.numpy()
    for b, n in enumerate((100, 64)):
        np.testing.assert_allclose(got_h[b, :n], ref_h[b, :n], atol=1e-4)
    np.testing.assert_allclose(np.asarray(out["pooler_output"]),
                               ref.pooler_output.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# end-to-end: converted checkpoint → predictor → golden probabilities
# ---------------------------------------------------------------------------

def test_converted_checkpoint_end_to_end_golden(tmp_path):
    if not REF_IMAGES.exists():
        pytest.skip("reference corpus not available")
    from transformers import BertConfig, BertModel

    from multimodal_rare_disease.config import resolve_config
    from multimodal_rare_disease.data.clinical_text import (
        load_clinical_descriptions,
    )
    from multimodal_rare_disease.data.tokenizer import get_tokenizer
    from multimodal_rare_disease.inference import load_predictor
    from multimodal_rare_disease.models import create_model
    from multimodal_rare_disease.models.convert import (
        convert_backbone_into,
        convert_bert_into,
        convert_hf_bert,
        convert_torchvision_resnet50,
    )
    from multimodal_rare_disease.utils.checkpoint import save_checkpoint

    cfg = resolve_config(overrides={
        "training.compute_dtype": "float32",
        "text_encoder.vocab_size": 4096,
        "text_encoder.num_layers": 2,   # full-size layers covered above;
        "text_encoder.num_heads": 12,   # keep CI wall-clock sane here
    })
    model = create_model(cfg, mode="multimodal")
    variables = model.init(
        jax.random.key(0),
        jnp.zeros((1, cfg.data.image_size, cfg.data.image_size, 3)),
        jnp.zeros((1, cfg.data.max_text_length), jnp.int32),
        jnp.ones((1, cfg.data.max_text_length), jnp.int32),
        train=False)
    params, batch_stats = variables["params"], variables.get("batch_stats", {})

    # converted random torch weights for both towers
    resnet_sd = _randomized_eval_resnet(seed=7).state_dict()
    bb_params, bb_stats = convert_torchvision_resnet50(resnet_sd)
    params, batch_stats = convert_backbone_into(
        params, batch_stats, bb_params, bb_stats)

    torch.manual_seed(7)
    hf = BertModel(BertConfig(
        vocab_size=4096, hidden_size=768, num_hidden_layers=2,
        num_attention_heads=12, intermediate_size=3072,
        max_position_embeddings=512, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)).eval()
    params = convert_bert_into(
        params, convert_hf_bert(hf.state_dict(), num_layers=2, num_heads=12))

    tok = get_tokenizer()
    meta = {
        "mode": "multimodal",
        "config": cfg.to_dict(),
        "vocab": [t for t, _ in sorted(tok.vocab.items(),
                                       key=lambda kv: kv[1])],
    }
    ckpt = tmp_path / "multimodal_best"
    save_checkpoint(ckpt, params, batch_stats, step=0, meta=meta)

    pred = load_predictor(ckpt)
    img = sorted(REF_IMAGES.glob("SYN_AS_*.png"))[0]
    desc = load_clinical_descriptions(cfg)
    text = desc["Angelman Syndrome"]["clinical_description"]
    result = pred.predict(image=img, text=text, top_k=5)

    probs = np.array([result["all_probabilities"][n]
                      for n in sorted(result["all_probabilities"])])
    assert abs(probs.sum() - 1.0) < 1e-4

    if not GOLDEN.exists():
        GOLDEN.parent.mkdir(parents=True, exist_ok=True)
        GOLDEN.write_text(json.dumps({
            "probs": {n: float(v)
                      for n, v in result["all_probabilities"].items()},
            "note": "pinned from converted random torch weights (seed 7); "
                    "regenerate only on intentional numerics changes",
        }, indent=2))
        pytest.skip("golden file created; rerun to assert")

    golden = json.loads(GOLDEN.read_text())["probs"]
    for name, v in golden.items():
        # the BASELINE ±1e-3 probability contract
        assert abs(result["all_probabilities"][name] - v) < 1e-3, name


# ---------------------------------------------------------------------------
# torch EfficientNet-B0 with the torchvision state_dict schema
# ---------------------------------------------------------------------------

class _ConvBNAct(torch.nn.Sequential):
    def __init__(self, cin, cout, k, stride, groups=1, act=True):
        nn = torch.nn
        layers = [nn.Conv2d(cin, cout, k, stride, padding=(k - 1) // 2,
                            groups=groups, bias=False),
                  nn.BatchNorm2d(cout, eps=1e-3)]
        if act:
            layers.append(nn.SiLU(inplace=True))
        super().__init__(*layers)


class _SE(torch.nn.Module):
    def __init__(self, c, squeeze):
        super().__init__()
        nn = torch.nn
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc1 = nn.Conv2d(c, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, c, 1)
        self.activation = nn.SiLU()
        self.scale_activation = nn.Sigmoid()

    def forward(self, x):
        s = self.avgpool(x)
        s = self.activation(self.fc1(s))
        return x * self.scale_activation(self.fc2(s))


class _MBConv(torch.nn.Module):
    def __init__(self, cin, cout, expand, k, stride):
        super().__init__()
        mid = cin * expand
        layers = []
        if expand != 1:
            layers.append(_ConvBNAct(cin, mid, 1, 1))
        layers.append(_ConvBNAct(mid, mid, k, stride, groups=mid))
        layers.append(_SE(mid, max(1, cin // 4)))
        layers.append(_ConvBNAct(mid, cout, 1, 1, act=False))
        self.block = torch.nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout

    def forward(self, x):
        out = self.block(x)
        return out + x if self.use_res else out


class _TorchEffNetB0(torch.nn.Module):
    """torchvision.models.efficientnet_b0-compatible keys and eval
    semantics (StochasticDepth is identity at eval and parameter-free)."""

    _CFG = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
            (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
            (6, 320, 1, 1, 3))

    def __init__(self):
        super().__init__()
        nn = torch.nn
        feats = [_ConvBNAct(3, 32, 3, 2)]
        cin = 32
        for expand, cout, repeats, stride, k in self._CFG:
            blocks = []
            for r in range(repeats):
                blocks.append(_MBConv(cin, cout, expand, k,
                                      stride if r == 0 else 1))
                cin = cout
            feats.append(nn.Sequential(*blocks))
        feats.append(_ConvBNAct(320, 1280, 1, 1))
        self.features = nn.Sequential(*feats)
        self.avgpool = nn.AdaptiveAvgPool2d(1)

    def forward(self, x):
        return self.avgpool(self.features(x)).flatten(1)


def test_efficientnet_b0_full_forward_parity():
    from multimodal_rare_disease.models.convert import (
        convert_torchvision_efficientnet_b0,
    )
    from multimodal_rare_disease.models.efficientnet import (
        EfficientNetB0Encoder,
    )

    torch.manual_seed(0)
    m = _TorchEffNetB0()
    for mod in m.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            with torch.no_grad():
                mod.running_mean.normal_(0, 0.02)
                mod.running_var.uniform_(0.8, 1.2)
    m = m.eval()
    sd = m.state_dict()
    assert "features.1.0.block.0.0.weight" in sd   # stage1 dw conv
    assert "features.2.0.block.2.fc1.weight" in sd  # SE fc1

    params, stats = convert_torchvision_efficientnet_b0(sd)

    enc = EfficientNetB0Encoder()
    # structural coverage: converted tree == init tree shapes
    x0 = jnp.zeros((1, 64, 64, 3))
    ref_vars = enc.init(jax.random.key(0), x0)
    ref_shapes = jax.tree_util.tree_map(lambda a: a.shape,
                                        ref_vars["params"])
    got_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params)
    assert ref_shapes == got_shapes

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32) * 0.5
    with torch.no_grad():
        ref = m(torch.tensor(x.transpose(0, 3, 1, 2))).numpy()
    pooled, feats = enc.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=False)
    ours = np.asarray(pooled)
    assert ours.shape == ref.shape == (2, 1280)
    np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=1e-3)
