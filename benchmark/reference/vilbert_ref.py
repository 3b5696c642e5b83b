"""Plain ViLBERT / UniMM-UL in PyTorch: the benchmark's reference.

The two-stream model of the configuration files under ``benchmark/configs``
(the reference repository's ``vilbert_dialog.py``: BERT text stream, region
stream, co-attention connection layers in its interleave, ReLU poolers, the
tied MLM decoder, the fused NSP head, the region-class head) and the
UniMM-UL training objective (MLM likelihood + unlikelihood, NSP, masked
region KL) with the grouped AdamW of ``train.py``. It imports nothing of
the program: the same descriptors (mode, ctx_end, ans_len) give the same
masks, and the same weights, handed to both sides, give the same function.

Precision: fp32 with TF32 off (``Precision("fp32")``). ``Precision("fp8")``
is the check's control: it rounds both operands of every matrix product to
float8 e4m3 with a per-tensor scale (and, in the backward, the gradient to
e5m2), the step a lower-precision port would take.

Training dropout: the program draws its masks from a device generator in
the model's order and its text attention's probability masks from the
Philox4x32-10 stream keyed by a host-drawn seed and (sequence, head). The
reference draws them again (``RefRng``): the same generator seeds, the same
draw order and shapes (the whole batch's, so a block of rows slices the
mask it would have drawn), and Philox written out below.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG = -10000.0
LN_EPS = 1e-12


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def _fp8(t, dtype=torch.float8_e4m3fn):
    """``t`` rounded to an fp8 format under a per-tensor scale that maps
    its largest magnitude to the format's largest value."""
    top = torch.finfo(dtype).max
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


def _sum_to(g, shape):
    """``g`` summed over the dimensions that broadcasting added to
    ``shape``."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _Fp8Matmul(torch.autograd.Function):
    """a @ b on e4m3-rounded operands; the backward's two products on the
    e5m2-rounded gradient and the same rounded operands (fp8 training's
    recipe), each with its own per-tensor scale."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = (a.shape, b.shape)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        return _sum_to(ga, ctx.shapes[0]), _sum_to(gb, ctx.shapes[1])


class Precision:
    """How the reference multiplies: "fp32" (exact fp32, no TF32) or "fp8"
    (the operands of every product, forward and backward, rounded to fp8:
    the control)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def mm(self, a, b):
        if self.kind == "fp8":
            return _Fp8Matmul.apply(a, b)
        return torch.matmul(a, b)

    def linear(self, x, w, b):
        return self.mm(x, w.t()) + b


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: dict):
    """[(name, shape)] of every parameter, in the published state_dict
    names (including the unused ``sep_embeddings`` and ``q_dense`` tables,
    which the checkpoint format carries)."""
    H, V, I = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]
    Hv, Iv = cfg["v_hidden_size"], cfg["v_intermediate_size"]
    Hb = cfg["bi_hidden_size"]
    out = []

    def lin(name, o, i):
        out.extend([(name + ".weight", (o, i)), (name + ".bias", (o,))])

    def ln(name, d):
        out.extend([(name + ".weight", (d,)), (name + ".bias", (d,))])

    e = "bert.embeddings."
    out += [(e + "word_embeddings.weight", (V, H)),
            (e + "position_embeddings.weight",
             (cfg["max_position_embeddings"], H)),
            (e + "token_type_embeddings.weight", (cfg["type_vocab_size"], H)),
            (e + "token_type_embeddings_extension.weight", (10, H)),
            (e + "sep_embeddings.weight", (50, H))]
    ln(e + "LayerNorm", H)
    lin("bert.v_embeddings.image_embeddings", Hv, cfg["v_feature_size"])
    lin("bert.v_embeddings.image_location_embeddings", Hv, 5)
    ln("bert.v_embeddings.LayerNorm", Hv)

    def layer(pre, d, inter):
        for n in ("query", "key", "value"):
            lin(f"{pre}.attention.self.{n}", d, d)
        lin(f"{pre}.attention.output.dense", d, d)
        ln(f"{pre}.attention.output.LayerNorm", d)
        lin(f"{pre}.intermediate.dense", inter, d)
        lin(f"{pre}.output.dense", d, inter)
        ln(f"{pre}.output.LayerNorm", d)

    for i in range(cfg["num_hidden_layers"]):
        layer(f"bert.encoder.layer.{i}", H, I)
    for i in range(cfg["v_num_hidden_layers"]):
        layer(f"bert.encoder.v_layer.{i}", Hv, Iv)
    for i in range(len(cfg["v_biattention_id"])):
        c = f"bert.encoder.c_layer.{i}"
        for n in ("query1", "key1", "value1"):
            lin(f"{c}.biattention.{n}", Hb, Hv)
        for n in ("query2", "key2", "value2"):
            lin(f"{c}.biattention.{n}", Hb, H)
        lin(f"{c}.biOutput.dense1", Hv, Hb)
        ln(f"{c}.biOutput.LayerNorm1", Hv)
        lin(f"{c}.biOutput.q_dense1", Hv, Hb)
        lin(f"{c}.biOutput.dense2", H, Hb)
        ln(f"{c}.biOutput.LayerNorm2", H)
        lin(f"{c}.biOutput.q_dense2", H, Hb)
        lin(f"{c}.v_intermediate.dense", Iv, Hv)
        lin(f"{c}.v_output.dense", Hv, Iv)
        ln(f"{c}.v_output.LayerNorm", Hv)
        lin(f"{c}.t_intermediate.dense", I, H)
        lin(f"{c}.t_output.dense", H, I)
        ln(f"{c}.t_output.LayerNorm", H)
    lin("bert.t_pooler.dense", Hb, H)
    lin("bert.v_pooler.dense", Hb, Hv)
    lin("cls.predictions.transform.dense", H, H)
    ln("cls.predictions.transform.LayerNorm", H)
    out.append(("cls.predictions.bias", (V,)))
    lin("cls.bi_seq_relationship", 2, Hb)
    lin("cls.imagePredictions.transform.dense", Hv, Hv)
    ln("cls.imagePredictions.transform.LayerNorm", Hv)
    lin("cls.imagePredictions.decoder", cfg["v_target_size"], Hv)
    return out


def make_weights(cfg: dict, seed: int, std: float, device) -> dict:
    """fp32 weights drawn from ``seed`` on ``device`` in one call: every
    tensor normal(0, std), LayerNorm scales 1 + normal(0, std). The same
    seed on the same device gives the same bits."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    buf = torch.empty(total, dtype=torch.float32, device=device)
    buf.normal_(0.0, std, generator=gen)
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = buf[off:off + n].view(shape)
        if "LayerNorm.weight" in name:
            t += 1.0
        out[name] = t
        off += n
    return out


# ---------------------------------------------------------------------------
# masks (from the (mode, ctx_end, ans_len) descriptor)
# ---------------------------------------------------------------------------

def text_mask(mode, L, A, n: int):
    """bool [B, n, n]: may row i attend column j. mode 0 (discriminative):
    the first L tokens attend each other; mode 1 (generative): [CLS] the
    whole sequence, the context (tokens 1 .. L - A - 1) itself, the answer's
    first copy causally, its masked second copy the first copy before its
    own position and itself."""
    mode, L, A = (t[:, None, None] for t in (mode, L, A))
    i = torch.arange(n, device=L.device)[:, None]
    j = torch.arange(n, device=L.device)[None, :]
    T = torch.clamp(L + A, max=n)
    Lc = L - A
    dis = (i < L) & (j < L)
    gen = (((i == 0) & (j < T))
           | ((i >= 1) & (i < Lc) & (((j >= 1) & (j < Lc)) | (i == j)))
           | ((i >= Lc) & (i < L) & (j >= 1) & (j <= i))
           | ((i >= L) & (i < T) & (((j >= 1) & (j < i - A)) | (i == j))))
    return torch.where(mode == 0, dis, gen)


def co_mask(mode, L, A, n: int):
    """bool [B, n]: text columns the regions attend (generative: the
    context only)."""
    mode, L, A = (t[:, None] for t in (mode, L, A))
    j = torch.arange(n, device=L.device)[None, :]
    return torch.where(mode == 0, j < L, (j >= 1) & (j < L - A))


def positions(mode, L, A, n: int):
    """Position ids; the generative masked copy repeats the first copy's."""
    mode, L, A = (t[:, None] for t in (mode, L, A))
    i = torch.arange(n, device=L.device)[None, :]
    T = torch.clamp(L + A, max=n)
    gen = torch.where(i < L, i, torch.where(i < T, i - A, 0))
    return torch.where(mode == 0, torch.where(i < L, i, 0), gen)


def _bias(mask_bool):
    return torch.where(mask_bool, 0.0, NEG).float()


# ---------------------------------------------------------------------------
# the training dropout streams
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b):
    t_lo = a * (b & 0xFFFF)
    t_hi = a * (b >> 16)
    s = t_lo + ((t_hi & 0xFFFF) << 16)
    return (t_hi >> 16) + (s >> 32), s & _MASK32


def philox_keep(seed: int, tags, n: int, rate: float):
    """fp32 scale mask [*tags.shape, n, n] of Philox4x32-10: counter
    (column // 4, row, 0, 0), key (seed, tag); word w of a draw is column
    4 c + w; kept where the word is below keep * 2^32."""
    tags = torch.as_tensor(tags, dtype=torch.int64)
    dev = tags.device
    c0 = torch.arange(n // 4, dtype=torch.int64, device=dev)[None, :]
    c1 = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    c2 = torch.zeros((), dtype=torch.int64, device=dev)
    c3 = torch.zeros((), dtype=torch.int64, device=dev)
    k0 = torch.full((), seed & _MASK32, dtype=torch.int64, device=dev)
    k1 = tags[..., None, None] & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = (hi1 ^ c1 ^ k0), lo1, (hi0 ^ c3 ^ k1), lo0
    bits = torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), -1)
    bits = bits.flatten(-2)
    keep = 1.0 - rate
    thr = min(int(keep * 2 ** 32), 2 ** 32 - 1)
    return torch.where(bits < thr, 1.0 / keep, 0.0).float()


class RefRng:
    """The program's dropout stream of one training step, drawn again: a
    device generator (masks, Bernoulli(1 - rate) / (1 - rate), drawn at
    the whole batch's shape ``(batch, ...)`` and cut to ``rows``) and a
    host generator (the Philox seeds of the text attention)."""

    def __init__(self, seed: int, device, batch: int, rows: slice):
        self.dev = torch.Generator(device=device)
        self.dev.manual_seed(seed)
        self.host = torch.Generator()
        self.host.manual_seed(seed ^ 0x5DEECE66D)
        self.device = torch.device(device)
        self.batch = batch
        self.rows = rows

    def drop(self, x, rate: float):
        if rate == 0.0:
            return x
        keep = 1.0 - rate
        m = torch.empty((self.batch,) + tuple(x.shape[1:]),
                        dtype=torch.float32, device=self.device)
        m.bernoulli_(keep, generator=self.dev).mul_(1.0 / keep)
        return x * m[self.rows]

    def kernel_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.host))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _ln(W, pre, x):
    return F.layer_norm(x, x.shape[-1:], W[pre + ".weight"],
                        W[pre + ".bias"], LN_EPS)


def _heads(x, h):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h).transpose(1, 2)


def _merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class Model:
    """The reference forward over weights ``W`` (name -> fp32 tensor)."""

    def __init__(self, cfg: dict, W: dict, prec: Precision):
        self.cfg, self.W, self.p = cfg, W, prec

    def lin(self, pre, x):
        return self.p.linear(x, self.W[pre + ".weight"], self.W[pre + ".bias"])

    def attend(self, q, k, v, bias, nh, drop=None):
        """Softmax attention over ``nh`` heads; ``drop(probs)`` applies a
        probability-dropout mask."""
        q, k, v = _heads(q, nh), _heads(k, nh), _heads(v, nh)
        s = self.p.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        probs = torch.softmax(s + bias, dim=-1)
        if drop is not None:
            probs = drop(probs)
        return _merge(self.p.mm(probs, v))

    def ffn(self, pre_in, pre_out, x, rate, rng):
        h = F.gelu(self.lin(pre_in + ".dense", x))
        h = self.lin(pre_out + ".dense", h)
        if rng is not None:
            h = rng.drop(h, rate)
        return _ln(self.W, pre_out + ".LayerNorm", h + x)

    def text_layer(self, i, x, bias, rng, tags):
        cfg, pre = self.cfg, f"bert.encoder.layer.{i}"
        m_o = seed = None
        if rng is not None:
            # the program's order: the hidden-dropout mask, then the
            # attention's Philox seed
            m_o = rng.drop(torch.ones_like(x),
                           cfg["hidden_dropout_prob"])
            seed = rng.kernel_seed()
        drop = None
        if rng is not None and cfg["attention_probs_dropout_prob"] > 0:
            def drop(probs):
                return probs * philox_keep(
                    seed, tags, probs.shape[-1],
                    cfg["attention_probs_dropout_prob"])
        a = pre + ".attention"
        ctx = self.attend(self.lin(a + ".self.query", x),
                          self.lin(a + ".self.key", x),
                          self.lin(a + ".self.value", x), bias,
                          cfg["num_attention_heads"], drop)
        h = self.lin(a + ".output.dense", ctx)
        if m_o is not None:
            h = h * m_o
        y = _ln(self.W, a + ".output.LayerNorm", h + x)
        return self.ffn(pre + ".intermediate", pre + ".output", y,
                        cfg["hidden_dropout_prob"], rng)

    def v_layer(self, i, x, bias, rng):
        cfg, a = self.cfg, f"bert.encoder.v_layer.{i}.attention"
        rate = cfg["v_attention_probs_dropout_prob"]
        drop = (lambda t: rng.drop(t, rate)) if rng is not None else None
        ctx = self.attend(self.lin(a + ".self.query", x),
                          self.lin(a + ".self.key", x),
                          self.lin(a + ".self.value", x), bias,
                          cfg["v_num_attention_heads"], drop)
        h = self.lin(a + ".output.dense", ctx)
        if rng is not None:
            h = rng.drop(h, cfg["v_hidden_dropout_prob"])
        y = _ln(self.W, a + ".output.LayerNorm", h + x)
        pre = f"bert.encoder.v_layer.{i}"
        return self.ffn(pre + ".intermediate", pre + ".output", y,
                        cfg["v_hidden_dropout_prob"], rng)

    def c_layer(self, i, v_x, t_x, v_bias, co_bias, rng):
        """BertConnectionLayer, with the reference's argument swap: the
        regions' context feeds the region residual through dense1, the
        text's context the text residual through dense2."""
        cfg, c = self.cfg, f"bert.encoder.c_layer.{i}"
        nh = cfg["bi_num_attention_heads"]
        b = c + ".biattention"

        def dropper(rate):
            return (lambda t: rng.drop(t, rate)) if rng is not None else None

        ctx_v = self.attend(self.lin(b + ".query1", v_x),
                            self.lin(b + ".key2", t_x),
                            self.lin(b + ".value2", t_x), co_bias, nh,
                            dropper(cfg["attention_probs_dropout_prob"]))
        v_h = self.lin(c + ".biOutput.dense1", ctx_v)
        if rng is not None:
            v_h = rng.drop(v_h, cfg["v_hidden_dropout_prob"])
        v_out = _ln(self.W, c + ".biOutput.LayerNorm1", v_h + v_x)
        ctx_t = self.attend(self.lin(b + ".query2", t_x),
                            self.lin(b + ".key1", v_x),
                            self.lin(b + ".value1", v_x), v_bias, nh,
                            dropper(cfg["v_attention_probs_dropout_prob"]))
        t_h = self.lin(c + ".biOutput.dense2", ctx_t)
        if rng is not None:
            t_h = rng.drop(t_h, cfg["hidden_dropout_prob"])
        t_out = _ln(self.W, c + ".biOutput.LayerNorm2", t_h + t_x)
        v_out = self.ffn(c + ".v_intermediate", c + ".v_output", v_out,
                         cfg["v_hidden_dropout_prob"], rng)
        t_out = self.ffn(c + ".t_intermediate", c + ".t_output", t_out,
                         cfg["hidden_dropout_prob"], rng)
        return v_out, t_out

    def encode(self, b, rng=None, row0: int = 0):
        """(t_seq, v_seq, pooled_t, pooled_v) of a descriptor batch ``b``
        (tokens / segments [B, n], mode / ctx_end / ans_len [B],
        image_feat [B, R, F], image_loc [B, R, 5], image_mask [B, R]);
        ``row0``: the batch's first row in the whole batch (the Philox
        tags)."""
        cfg, W = self.cfg, self.W
        tok, seg = b["tokens"].long(), b["segments"].long()
        n = tok.shape[1]
        mode, L, A = (b[k].long() for k in ("mode", "ctx_end", "ans_len"))
        t_bias = _bias(text_mask(mode, L, A, n))[:, None]
        co_bias = _bias(co_mask(mode, L, A, n))[:, None, None]
        v_bias = _bias(b["image_mask"] > 0)[:, None, None]
        nt = cfg["type_vocab_size"]
        e = "bert.embeddings."
        te = torch.where((seg >= nt)[..., None],
                         F.embedding((seg - nt).clamp(min=0),
                                     W[e + "token_type_embeddings_extension"
                                       ".weight"]),
                         F.embedding(seg.clamp(max=nt - 1),
                                     W[e + "token_type_embeddings.weight"]))
        t_x = (F.embedding(tok, W[e + "word_embeddings.weight"])
               + F.embedding(positions(mode, L, A, n),
                             W[e + "position_embeddings.weight"]) + te)
        t_x = _ln(W, e + "LayerNorm", t_x)
        v_x = (self.lin("bert.v_embeddings.image_embeddings",
                        b["image_feat"].float())
               + self.lin("bert.v_embeddings.image_location_embeddings",
                          b["image_loc"].float()))
        v_x = _ln(W, "bert.v_embeddings.LayerNorm", v_x)
        if rng is not None:
            t_x = rng.drop(t_x, cfg["hidden_dropout_prob"])
            # BertImageEmbeddings drops at the text stream's rate
            v_x = rng.drop(v_x, cfg["hidden_dropout_prob"])
        nh = cfg["num_attention_heads"]
        tags = ((torch.arange(tok.shape[0], device=tok.device)[:, None]
                 + row0) * nh + torch.arange(nh, device=tok.device)[None, :])
        v0 = t0 = 0
        for c, (v1, t1) in enumerate(zip(cfg["v_biattention_id"],
                                         cfg["t_biattention_id"])):
            for i in range(v0, v1):
                v_x = self.v_layer(i, v_x, v_bias, rng)
            for i in range(t0, t1):
                t_x = self.text_layer(i, t_x, t_bias, rng, tags)
            v_x, t_x = self.c_layer(c, v_x, t_x, v_bias, co_bias, rng)
            v0, t0 = v1, t1
        for i in range(v0, cfg["v_num_hidden_layers"]):
            v_x = self.v_layer(i, v_x, v_bias, rng)
        for i in range(t0, cfg["num_hidden_layers"]):
            t_x = self.text_layer(i, t_x, t_bias, rng, tags)
        pooled_t = F.relu(self.lin("bert.t_pooler.dense", t_x[:, 0]))
        pooled_v = F.relu(self.lin("bert.v_pooler.dense", v_x[:, 0]))
        return t_x, v_x, pooled_t, pooled_v

    def label_nll(self, t_seq, pos):
        """NLL [B, P] of the labels at positions ``pos`` [B, P] over the
        tied decoder, from fp32 logits; the caller masks unused slots."""
        idx = pos[..., None].expand(*pos.shape, t_seq.shape[-1])
        h = torch.gather(t_seq, 1, idx)
        h = F.gelu(self.lin("cls.predictions.transform.dense", h))
        h = _ln(self.W, "cls.predictions.transform.LayerNorm", h)
        logits = (self.p.mm(h, self.W["bert.embeddings.word_embeddings"
                                      ".weight"].t())
                  + self.W["cls.predictions.bias"])
        return torch.log_softmax(logits, -1)

    def nsp_logits(self, pooled_t, pooled_v, rng=None):
        pooled = pooled_t * pooled_v
        if rng is not None:
            pooled = rng.drop(pooled, self.cfg["head_dropout_prob"])
        return self.lin("cls.bi_seq_relationship", pooled)


def _label_slots(labels):
    """(positions [B, P], labels there, -1 unused): every labelled
    position of each row, in order."""
    is_lab = labels != -1
    P = max(int(is_lab.sum(-1).max()), 1)
    order = torch.argsort((~is_lab).to(torch.int8), dim=-1, stable=True)
    pos = order[:, :P]
    return pos, torch.gather(labels, 1, pos)


@torch.no_grad()
def score(cfg: dict, W: dict, b: dict, prec: Precision) -> dict:
    """Eval scores of a flat descriptor batch: ``ll_sum`` [B] (the answer's
    summed log-likelihood at its labels) and ``nsp_margin`` [B] (NSP logit
    0 - logit 1)."""
    _no_tf32()
    m = Model(cfg, W, prec)
    t_seq, _, pt, pv = m.encode(b)
    labels = b["mlm_labels"].long()
    pos, labs = _label_slots(labels)
    logp = m.label_nll(t_seq, pos)
    tok = torch.gather(logp, -1, labs.clamp(min=0)[..., None])[..., 0]
    ll = torch.where(labs != -1, tok, 0.0).sum(-1)
    nsp = m.nsp_logits(pt, pv)
    return {"ll_sum": ll, "nsp_margin": nsp[:, 0] - nsp[:, 1]}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def world_norms(batch: dict) -> dict:
    """The loss denominators of the whole batch: label tokens with a
    weight, masked regions, and the NSP label counts."""
    nsl = batch["next_sentence_label"].long()
    return {"lm": (batch["lm_weight"] != 0).float().sum(),
            "img": (batch["image_label"] == 1).float().sum(),
            "nsp": torch.stack([(nsl == 0).sum(), (nsl == 1).sum()]).float()}


def train_loss(cfg: dict, W: dict, b: dict, norms: dict, *, seed: int,
               batch: int, rows: slice, prec: Precision, nsp_weight):
    """The UniMM-UL loss of rows ``rows`` of a training batch (``b`` holds
    those rows), each part summed over them and divided by the whole
    batch's denominators ``norms``, so the blocks' losses add up to the
    batch's. Dropout drawn as the program's step ``seed`` draws it."""
    _no_tf32()
    rng = RefRng(seed, b["tokens"].device, batch, rows)
    m = Model(cfg, W, prec)
    t_seq, v_seq, pt, pv = m.encode(b, rng, row0=rows.start or 0)
    labels = b["mlm_labels"].long()
    pos, labs = _label_slots(labels)
    logp = m.label_nll(t_seq, pos)
    lp = torch.gather(logp, -1, labs.clamp(min=0)[..., None])[..., 0]
    w = torch.gather(b["lm_weight"].float(), 1, pos)
    valid = labs != -1
    nll = -lp
    l_sum = torch.where(valid & (w > 0), nll * w, 0.0).sum()
    ul = -torch.log(torch.clamp(1.0 - torch.exp(lp), min=1e-6))
    ul_sum = torch.where(valid & (w == -1), ul, 0.0).sum()
    lm = (l_sum + ul_sum) / torch.clamp(norms["lm"], min=1.0)
    nsp = m.nsp_logits(pt, pv, rng)
    nw = torch.as_tensor(nsp_weight, dtype=torch.float32,
                         device=nsp.device)
    nw = nw / nw[0]
    y = b["next_sentence_label"].long()
    nsp_nll = -torch.gather(torch.log_softmax(nsp, -1), -1, y[:, None])[:, 0]
    nsp_loss = (nsp_nll * nw[y]).sum() / (norms["nsp"] * nw).sum()
    hv = F.gelu(m.lin("cls.imagePredictions.transform.dense", v_seq))
    hv = _ln(W, "cls.imagePredictions.transform.LayerNorm", hv)
    img_logp = torch.log_softmax(m.lin("cls.imagePredictions.decoder", hv),
                                 -1)
    tgt = b["image_target"].float()
    kld = torch.where(tgt > 0, tgt * (torch.log(tgt.clamp(min=1e-30))
                                      - img_logp), 0.0)
    sel = (b["image_label"] == 1).float()
    img = (kld * sel[..., None]).sum() / torch.clamp(norms["img"], min=1.0)
    return lm + nsp_loss + img


def lr_at(step: int, base: float, opt: dict) -> float:
    """The warm-up-linear schedule with its floor (utils/optim_utils.py),
    read at update ``step`` (0 for the first)."""
    s = float(step)
    if s < opt["warmup_steps"]:
        lr = base * s / max(1, opt["warmup_steps"])
    else:
        lr = base * max((opt["t_total"] - s)
                        / max(1.0, opt["t_total"] - opt["warmup_steps"]), 0.0)
    return max(lr, opt["min_lr"])


class AdamW:
    """The reference's grouped AdamW (train.py, utils/optim_utils.py):
    moments as b m + (1 - b) g, bias correction by division, eps outside
    the square root, then -lr (direction + wd p); no decay for names
    containing "bias" or "LayerNorm.weight"; one learning rate here (the
    configuration gives text and image parameters the same)."""

    B1, B2 = 0.9, 0.999

    def __init__(self, W: dict, opt: dict):
        self.opt = opt
        self.mu = {n: torch.zeros_like(t) for n, t in W.items()}
        self.nu = {n: torch.zeros_like(t) for n, t in W.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, W: dict, grads: dict):
        o = self.opt
        lr = lr_at(self.count, o["lr"], o)
        t = self.count + 1
        bc1, bc2 = 1.0 - self.B1 ** t, 1.0 - self.B2 ** t
        for n, p in W.items():
            g = grads.get(n)
            if g is None:
                g = torch.zeros_like(p)
            wd = (0.0 if ("bias" in n or "LayerNorm.weight" in n)
                  else o["weight_decay"])
            self.mu[n] = self.B1 * self.mu[n] + (1 - self.B1) * g
            self.nu[n] = self.B2 * self.nu[n] + (1 - self.B2) * g * g
            d = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2)
                                      + o["adam_eps"])
            p.add_(-lr * (d + wd * p))
        self.count += 1
