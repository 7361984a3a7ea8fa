"""Layer-graph reconstructions of the models in the paper's Table 3.

The paper schedules at layer granularity using offline latency/energy tables;
it never needs weights — only layer *shapes*. We reconstruct each cited
architecture as an ordered layer list with realistic dimensions (channel
widths, feature-map sizes, filter sizes follow the cited papers; minor details
approximated). Dynamic behaviours (SkipNet skipping, RAPID-RL early exits,
Once-for-All Supernet variants) are attached per Section 2.2.
"""
from __future__ import annotations

from dataclasses import replace as _dc_replace

from .types import GenAIMeta, Layer, ModelGraph, OpType


def conv(name: str, K: int, C: int, R: int, Y: int, X: int, S: int | None = None) -> Layer:
    return Layer(name=name, op=OpType.CONV2D, K=K, C=C, R=R, S=S or R, Y=Y, X=X)


def dwconv(name: str, C: int, R: int, Y: int, X: int) -> Layer:
    return Layer(name=name, op=OpType.DWCONV, C=C, R=R, S=R, Y=Y, X=X)


def fc(name: str, K: int, C: int, M: int = 1) -> Layer:
    return Layer(name=name, op=OpType.FC, K=K, C=C, Y=M)


def pool(name: str, C: int, Y: int, X: int) -> Layer:
    return Layer(name=name, op=OpType.POOL, C=C, Y=Y, X=X)


def mbconv(prefix: str, c_in: int, c_out: int, expand: int, y: int, x: int,
           stride: int = 1) -> list[Layer]:
    """MobileNetV2/V3-style inverted-residual block at *output* resolution y,x."""
    hidden = c_in * expand
    layers = []
    if expand != 1:
        layers.append(conv(f"{prefix}.pw", hidden, c_in, 1, y * stride, x * stride))
    layers.append(dwconv(f"{prefix}.dw", hidden, 3, y, x))
    layers.append(conv(f"{prefix}.pwl", c_out, hidden, 1, y, x))
    return layers


def resblock(prefix: str, c_in: int, c_out: int, y: int, x: int) -> list[Layer]:
    return [
        conv(f"{prefix}.c1", c_out, c_in, 3, y, x),
        conv(f"{prefix}.c2", c_out, c_out, 3, y, x),
    ]


# ---------------------------------------------------------------------------
# Vision models
# ---------------------------------------------------------------------------

def fbnet_c(name: str = "fbnet_c_gaze", res: int = 320) -> ModelGraph:
    """FBNet-C backbone (CVPR'19) on a `res` x `res` eye region — gaze."""
    r = res // 2
    L: list[Layer] = [conv("stem", 16, 3, 3, r, r)]
    spec = [  # (c_out, expand, n, out_res)
        (24, 6, 3, r // 2), (32, 6, 3, r // 4), (64, 6, 3, r // 8),
        (112, 6, 3, r // 8), (184, 6, 3, r // 16), (352, 6, 1, r // 16),
    ]
    c = 16
    for si, (co, e, n, r) in enumerate(spec):
        for bi in range(n):
            L += mbconv(f"s{si}.b{bi}", c, co, e, r, r, stride=1 if bi else 2)
            c = co
    L += [conv("head", 1504, c, 1, r // 16, r // 16), pool("gap", 1504, 1, 1), fc("fc", 64, 1504)]
    return ModelGraph(name=name, layers=tuple(L))


def ssd_mobilenet_v2(name: str = "ssd_mnv2", res: int = 512) -> ModelGraph:
    """SSD-MobileNetV2 (ECCV'16 + CVPR'18) detector at `res` input."""
    r = res // 2
    L: list[Layer] = [conv("stem", 32, 3, 3, r, r)]
    c = 32
    spec = [(16, 1, 1, r), (24, 6, 2, r // 2), (32, 6, 3, r // 4),
            (64, 6, 4, r // 8), (96, 6, 3, r // 8), (160, 6, 3, r // 16),
            (320, 6, 1, r // 16)]
    for si, (co, e, n, rr) in enumerate(spec):
        for bi in range(n):
            L += mbconv(f"s{si}.b{bi}", c, co, e, rr, rr)
            c = co
    L.append(conv("feat", 1280, c, 1, r // 16, r // 16))
    # SSD extra feature layers + class/box heads over 6 scales
    fr, fc_ = r // 16, 1280
    for i in range(4):
        L.append(conv(f"extra{i}.a", 256, fc_, 1, fr, fr))
        fr = max(1, fr // 2)
        L.append(conv(f"extra{i}.b", 512, 256, 3, fr, fr))
        fc_ = 512
    for i, (hr, hc) in enumerate([(r // 16, 1280)] + [(max(1, r // 32 >> k), 512) for k in range(4)]):
        L.append(conv(f"head{i}.cls", 6 * 21, hc, 3, hr, hr))
        L.append(conv(f"head{i}.box", 6 * 4, hc, 3, hr, hr))
    return ModelGraph(name=name, layers=tuple(L))


def handpose_net(name: str = "handpose", res: int = 288) -> ModelGraph:
    """Global-to-local hand pose CNN (Madadi et al.) on depth crops."""
    L: list[Layer] = []
    c, r = 3, res // 2
    for i, co in enumerate([64, 128, 256, 256, 512]):
        L += resblock(f"rb{i}", c, co, r, r)
        c, r = co, max(r // 2, 9)
        L.append(pool(f"p{i}", c, r, r))
    L += [fc("fc1", 1024, c * 81), fc("fc2", 63, 1024)]
    return ModelGraph(name=name, layers=tuple(L))


def skipnet(name: str = "skipnet_ctx", skip_prob: float = 0.5,
            res: int = 288) -> ModelGraph:
    """SkipNet-101 (ECCV'18) with per-residual-block gating: each block is
    skipped with `skip_prob` (paper assumes 50%, 72% top-1). The deep
    ResNet-101 layout gives the large worst-vs-typical path gap that defeats
    conservative static scheduling (paper Section 2.2)."""
    q = res // 2
    L: list[Layer] = [conv("stem", 64, 3, 7, q, q), pool("mp", 64, q // 2, q // 2)]
    blocks: list[tuple[int, int]] = []
    c = 64
    for si, (co, n, r) in enumerate([(64, 3, q // 2), (128, 4, q // 4),
                                     (256, 23, q // 8), (512, 3, q // 16)]):
        for bi in range(n):
            start = len(L)
            L += resblock(f"s{si}.b{bi}", c, co, r, r)
            c = co
            if bi > 0:  # first block of a stage (downsample) is not skippable
                blocks.append((start, len(L)))
    L += [pool("gap", 512, 1, 1), fc("fc", 1000, 512)]
    return ModelGraph(name=name, layers=tuple(L), skip_blocks=tuple(blocks),
                      skip_prob=skip_prob)


def trailnet(name: str = "trailnet_nav") -> ModelGraph:
    """TrailNet (IROS'17): ResNet-18-style trail-following DNN on 448x256."""
    L: list[Layer] = [conv("stem", 64, 3, 7, 224, 128), pool("mp", 64, 112, 64)]
    c = 64
    for si, (co, n, y, x) in enumerate([(64, 2, 112, 64), (128, 2, 56, 32),
                                        (256, 2, 28, 16), (512, 2, 14, 8)]):
        for bi in range(n):
            L += resblock(f"s{si}.b{bi}", c, co, y, x)
            c = co
    L += [pool("gap", 512, 1, 1), fc("fc", 9, 512)]
    return ModelGraph(name=name, layers=tuple(L))


def sosnet(name: str = "sosnet_vo", patches: int = 196) -> ModelGraph:
    """SOSNet (CVPR'19) local descriptors: 7 convs on 32x32 patches; the
    per-frame patch batch is folded into the spatial dims."""
    s = int(patches ** 0.5)  # tile the patch batch into a sqrt grid
    L: list[Layer] = []
    dims = [(32, 1, 32), (32, 32, 32), (64, 32, 16), (64, 64, 16),
            (128, 64, 8), (128, 128, 8)]
    for i, (k, c, r) in enumerate(dims):
        L.append(conv(f"c{i}", k, c, 3, r * s, r * s))
    L.append(conv("c6", 128, 128, 8, s, s))  # final 8x8 valid conv -> descriptor
    return ModelGraph(name=name, layers=tuple(L))


def rapid_rl(name: str = "rapid_rl_nav") -> ModelGraph:
    """RAPID-RL (ICRA'22): conv trunk with preemptive exits on 168x168 frames."""
    L: list[Layer] = [
        conv("c0", 32, 4, 8, 40, 40),
        conv("c1", 64, 32, 4, 18, 18),
        fc("exit0", 6, 64 * 324),
        conv("c2", 64, 64, 3, 14, 14),
        fc("exit1", 6, 64 * 196),
        conv("c3", 128, 64, 3, 14, 14),
        fc("fc1", 512, 128 * 196),
        fc("fc2", 6, 512),
    ]
    # Preemptive exits after the early heads (exit prob. from the paper's spec)
    return ModelGraph(name=name, layers=tuple(L),
                      exit_points=((2, 0.4), (4, 0.4)))


def googlenet_car(name: str = "googlenet_car") -> ModelGraph:
    """GoogLeNet (CompCars fine-grained classifier) on 288x288."""
    L: list[Layer] = [
        conv("stem", 64, 3, 7, 144, 144), pool("p0", 64, 72, 72),
        conv("c1", 64, 64, 1, 72, 72), conv("c2", 192, 64, 3, 72, 72),
        pool("p1", 192, 36, 36),
    ]

    def inception(pfx, c_in, b1, b3r, b3, b5r, b5, pp, r):
        return [
            conv(f"{pfx}.1x1", b1, c_in, 1, r, r),
            conv(f"{pfx}.3r", b3r, c_in, 1, r, r),
            conv(f"{pfx}.3x3", b3, b3r, 3, r, r),
            conv(f"{pfx}.5r", b5r, c_in, 1, r, r),
            conv(f"{pfx}.5x5", b5, b5r, 5, r, r),
            conv(f"{pfx}.pp", pp, c_in, 1, r, r),
        ]

    cfg = [  # (c_in, b1, b3r, b3, b5r, b5, pp, res)
        (192, 64, 96, 128, 16, 32, 32, 36), (256, 128, 128, 192, 32, 96, 64, 36),
        (480, 192, 96, 208, 16, 48, 64, 18), (512, 160, 112, 224, 24, 64, 64, 18),
        (512, 128, 128, 256, 24, 64, 64, 18), (512, 112, 144, 288, 32, 64, 64, 18),
        (528, 256, 160, 320, 32, 128, 128, 18), (832, 256, 160, 320, 32, 128, 128, 9),
        (832, 384, 192, 384, 48, 128, 128, 9),
    ]
    for i, args in enumerate(cfg):
        L += inception(f"inc{i}", *args)
    L += [pool("gap", 1024, 1, 1), fc("fc", 431, 1024)]
    return ModelGraph(name=name, layers=tuple(L))


def focal_depth(name: str = "focal_depth") -> ModelGraph:
    """Focal-length-aware monocular depth (TIP'18): VGG-ish encoder +
    upsampling decoder at 384x384."""
    L: list[Layer] = []
    c, r = 3, 384
    for si, (co, n) in enumerate([(32, 2), (64, 2), (128, 3), (256, 3), (256, 3)]):
        for bi in range(n):
            L.append(conv(f"e{si}.c{bi}", co, c, 3, r, r))
            c = co
        r //= 2
        L.append(pool(f"e{si}.p", c, r, r))
    for di, co in enumerate([128, 64, 32, 16]):
        r *= 2
        L.append(conv(f"d{di}.up", co, c, 3, r, r))
        L.append(conv(f"d{di}.c", co, co, 3, r, r))
        c = co
    L.append(conv("pred", 1, c, 3, r, r))
    return ModelGraph(name=name, layers=tuple(L))


def ed_tcn(name: str = "ed_tcn_action") -> ModelGraph:
    """ED-TCN (CVPR'17) encoder-decoder temporal convnet over T=128 steps of
    2048-d frame features (1-D convs encoded with X=1)."""
    L: list[Layer] = []
    t, c = 256, 2048
    for i, co in enumerate([96, 96]):
        L.append(Layer(f"enc{i}", OpType.CONV2D, K=co, C=c, R=25, S=1, Y=t, X=1))
        c, t = co, t // 2
    for i, co in enumerate([96, 96]):
        t *= 2
        L.append(Layer(f"dec{i}", OpType.CONV2D, K=co, C=c, R=25, S=1, Y=t, X=1))
        c = co
    L.append(fc("cls", 48, c, M=t))
    return ModelGraph(name=name, layers=tuple(L))


def vgg_voxceleb(name: str = "vgg_vox_verif") -> ModelGraph:
    """VGG-M speaker/face verification (VoxCeleb, Interspeech'17) on a
    512x300 spectrogram."""
    L: list[Layer] = [
        conv("c1", 96, 1, 7, 254, 148), pool("p1", 96, 126, 73),
        conv("c2", 256, 96, 5, 62, 36), pool("p2", 256, 30, 17),
        conv("c3", 384, 256, 3, 30, 17),
        conv("c4", 256, 384, 3, 30, 17),
        conv("c5", 256, 256, 3, 30, 17), pool("p5", 256, 9, 8),
        fc("fc6", 4096, 256 * 9 * 8),
        fc("fc7", 1024, 4096),
        fc("fc8", 1251, 1024),
    ]
    return ModelGraph(name=name, layers=tuple(L))


# ---------------------------------------------------------------------------
# Audio / language models
# ---------------------------------------------------------------------------

def kws_res8(name: str = "kws_res8") -> ModelGraph:
    """res8 keyword spotting (ICASSP'18): 6 convs, 45 ch, 40x101 MFCC map."""
    L: list[Layer] = [conv("c0", 45, 1, 3, 20, 50)]
    for i in range(6):
        L.append(conv(f"c{i+1}", 45, 45, 3, 20, 50))
    L += [pool("gap", 45, 1, 1), fc("fc", 12, 45)]
    return ModelGraph(name=name, layers=tuple(L))


def gnmt(name: str = "gnmt_translate", chunk: int = 12, hidden: int = 1024,
         enc_layers: int = 4, dec_layers: int = 4, vocab: int = 8000) -> ModelGraph:
    """GNMT-style LSTM seq2seq (arXiv:1609.08144) in *streaming* form: each
    15-FPS frame consumes the newly arrived audio chunk (`chunk` encoder
    timesteps) and emits two decoder steps. Each LSTM step is two GEMV layers
    (input + recurrent, 4 gates); decoder steps add attention + logits."""
    L: list[Layer] = [fc("embed", hidden, vocab // 32)]  # embedding lookup slice
    for t in range(chunk):
        for l in range(enc_layers):
            L.append(fc(f"enc.t{t}.l{l}.ih", 4 * hidden, hidden))
            L.append(fc(f"enc.t{t}.l{l}.hh", 4 * hidden, hidden))
    for t in range(2):
        for l in range(dec_layers):
            L.append(fc(f"dec.t{t}.l{l}.ih", 4 * hidden, hidden))
            L.append(fc(f"dec.t{t}.l{l}.hh", 4 * hidden, hidden))
        L.append(fc(f"dec.t{t}.attn", hidden, 2 * hidden))
        L.append(fc(f"dec.t{t}.logits", vocab, hidden))
    return ModelGraph(name=name, layers=tuple(L))


def chat_llm(name: str = "chat_llm", d_model: int = 512,
             prompt_tokens: int = 96, n_blocks: int = 4,
             max_new_tokens: int = 24, token_mean: float = 10.0,
             vocab: int = 8000) -> ModelGraph:
    """Compact on-device chat LLM in autoregressive (prefill/decode) form.

    The prefill phase runs the transformer blocks as GEMMs over the whole
    ``prompt_tokens``-long prompt (compute-bound under the roofline); each
    decode step re-runs the same blocks as single-token GEMVs plus a
    logits projection (weight streaming dominates — memory-bound), and
    repeats once per generated token.  Per-job token counts are geometric
    with mean ``token_mean`` capped at ``max_new_tokens``; the two capped
    variants give the SLO degradation ladder its ``max_new_tokens`` rungs.
    """
    L: list[Layer] = []
    for i in range(n_blocks):
        # attention in/out + MLP up/down, folded to two fat GEMMs per block
        L.append(fc(f"prefill.b{i}.attn", 2 * d_model, d_model,
                    M=prompt_tokens))
        L.append(fc(f"prefill.b{i}.mlp", d_model, 2 * d_model,
                    M=prompt_tokens))
    prefill_len = len(L)
    for i in range(n_blocks):
        L.append(fc(f"decode.b{i}.attn", 2 * d_model, d_model))
        L.append(fc(f"decode.b{i}.mlp", d_model, 2 * d_model))
    L.append(fc("decode.logits", vocab // 8, d_model))
    meta = GenAIMeta(prefill_len=prefill_len, max_new_tokens=max_new_tokens,
                     token_mean=token_mean)
    base = ModelGraph(name=name, layers=tuple(L), genai=meta)
    variants = tuple(
        _dc_replace(base, name=f"{name}@v{k}",
                    genai=_dc_replace(meta, max_new_tokens=cap))
        for k, cap in enumerate(
            (max(max_new_tokens // 2, 1), max(max_new_tokens // 4, 1)),
            start=1))
    return _dc_replace(base, variants=variants)


# ---------------------------------------------------------------------------
# Once-for-All Supernet (4 weight-sharing variants, §4.5)
# ---------------------------------------------------------------------------

def _ofa_instance(name: str, depths: list[int], expand: int, width_mult: float,
                  res: int) -> ModelGraph:
    r = res // 2
    L: list[Layer] = [conv("stem", int(24 * width_mult), 3, 3, r, r)]
    c = int(24 * width_mult)
    stage_cfg = [(32, r // 2), (56, r // 4), (104, r // 8), (128, r // 8),
                 (248, r // 16)]
    for si, (co_base, rr) in enumerate(stage_cfg):
        co = int(co_base * width_mult)
        for bi in range(depths[si % len(depths)]):
            L += mbconv(f"s{si}.b{bi}", c, co, expand, rr, rr)
            c = co
    L += [conv("head", 1024, c, 1, r // 16, r // 16), pool("gap", 1024, 1, 1),
          fc("fc", 1000, 1024)]
    return ModelGraph(name=name, layers=tuple(L))


def ofa_supernet(name: str = "ofa_ctx") -> ModelGraph:
    """Once-for-All (ICLR'20) context-understanding Supernet with the original
    plus three lighter weight-sharing variants (ofa-s7edge-style)."""
    base = _ofa_instance(name, depths=[4, 4, 4, 4, 4], expand=6, width_mult=1.0, res=288)
    v1 = _ofa_instance(f"{name}@v1", depths=[3, 3, 3, 3, 3], expand=4, width_mult=1.0, res=256)
    v2 = _ofa_instance(f"{name}@v2", depths=[2, 2, 2, 2, 2], expand=4, width_mult=0.8, res=224)
    v3 = _ofa_instance(f"{name}@v3", depths=[2, 2, 2, 2, 2], expand=3, width_mult=0.65, res=192)
    return ModelGraph(name=base.name, layers=base.layers, variants=(v1, v2, v3))


ZOO_BUILDERS = {
    "fbnet_c": fbnet_c,
    "ssd_mnv2": ssd_mobilenet_v2,
    "handpose": handpose_net,
    "skipnet": skipnet,
    "trailnet": trailnet,
    "sosnet": sosnet,
    "rapid_rl": rapid_rl,
    "googlenet_car": googlenet_car,
    "focal_depth": focal_depth,
    "ed_tcn": ed_tcn,
    "vgg_voxceleb": vgg_voxceleb,
    "kws_res8": kws_res8,
    "gnmt": gnmt,
    "ofa": ofa_supernet,
    "chat_llm": chat_llm,
}


# ---------------------------------------------------------------------------
# Memoized builds
# ---------------------------------------------------------------------------
# Placement-time cost estimation rebuilds the same architecture thousands of
# times under per-stream instance names.  The cost-table fast cache
# (costmodel._FAST_TABLE_CACHE) is keyed by the *identity* of the frozen
# ``layers`` tuple, so every fresh build used to fall through to a structural
# hash over hundreds of Layer dataclasses.  Cache one graph per
# (builder, kwargs) and rename via ``dataclasses.replace`` — the layers
# tuple keeps a single identity fleet-wide, and only the top-level (and
# ``{name}@vK`` variant) name strings differ between instances.

_BUILD_CACHE: dict = {}
_RELABEL_CACHE: dict = {}
_RELABEL_MAX = 65536


def _relabel(g: ModelGraph, name: str) -> ModelGraph:
    """Rename ``g`` (and its ``{old}@vK`` variant prefixes) without touching
    structure; layer tuples are shared with the donor graph."""
    old = g.name
    variants = tuple(
        _dc_replace(v, name=name + v.name[len(old):])
        if v.name.startswith(old) else v
        for v in g.variants)
    return _dc_replace(g, name=name, variants=variants)


def build_cached(builder: str, name: str | None = None,
                 kwargs: dict | None = None) -> ModelGraph:
    """``ZOO_BUILDERS[builder](**kwargs, name=name)`` with structure sharing.

    Graphs are immutable, and no builder lets ``name`` influence layer
    shapes, so two builds differing only in ``name`` may share every layer.
    Unhashable kwarg values fall back to a direct (uncached) build.
    """
    fn = ZOO_BUILDERS[builder]
    kw = dict(kwargs or {})
    kw.pop("name", None)
    try:
        key = (builder, tuple(sorted(kw.items())))
    except TypeError:                        # unhashable kwarg value
        if name is not None:
            kw["name"] = name
        return fn(**kw)
    g = _BUILD_CACHE.get(key)
    if g is None:
        g = _BUILD_CACHE[key] = fn(**kw)
    if name is None or name == g.name:
        return g
    rk = (id(g), name)
    rg = _RELABEL_CACHE.get(rk)
    if rg is None:
        if len(_RELABEL_CACHE) >= _RELABEL_MAX:
            _RELABEL_CACHE.clear()
        rg = _RELABEL_CACHE[rk] = _relabel(g, name)
    return rg
