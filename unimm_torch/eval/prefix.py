"""Prefix-cache generative scoring: prefill each slate's shared context once,
then score all answer options against the cached context K/V.

The port of the JAX package's ``eval/prefix.py`` packed path. Under the
generative masks the context rows and the whole vision stream of a slate
are identical across its options at every layer (context rows never attend
[CLS] or either answer copy; the image stream attends only context
columns). So per slate:

1. **Context prefill**: one plain encoder forward over the context only
   (descriptor ``mode=gen, ctx_end=Lc, ans_len=0``), tapping each text
   layer's input and each connection layer's vision input.
2. **Answer pass**: only the ``2 * ans_len`` answer rows of every option,
   packed contiguously into row blocks, run through the text stream; their
   queries attend the cached context K/V plus their own option's rows.
   Under ``attention_impl="pallas_block"`` each text layer is one
   ``answer_block`` kernel plus one ``ffn_block`` kernel, each connection
   layer a plain co-attention over the cached vision stream plus one
   ``ffn_block``, and the label head is the ``xent_head`` kernel; under
   ``"xla"`` the same three steps run their plain versions.

Exact up to float rounding: masked columns add exp(-1e4) = 0 to the fp32
softmax, so the scores equal the flat full-forward scores
(``models/unimm.forward_eval``).

Not in this slice: the W-padded answer layout (groups whose largest option
does not fit a row block) and the mesh / multi-process arguments; both are
queued in ROADMAP.md.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from unimm_torch.config import VilbertConfig
from unimm_torch.models import unimm, vilbert
from unimm_torch.ops import masks
from unimm_torch.ops.answer_block import answer_block, answer_block_plain
from unimm_torch.ops.ffn_block import ffn_block, ffn_block_plain
from unimm_torch.ops.xent_head import xent_head, xent_head_plain

W_PADDED_NOT_PORTED = ("the W-padded answer layout (_answer_impl) is not ported "
                 "yet: ROADMAP.md queue A, 'W-padded answer pass'")


def slate_eligibility(batch) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side per-slate prefix eligibility for a [B, R, O] val batch.

    A slate qualifies when every option is generative, shares the identical
    context prefix (tokens and segments on ``[0, Lc)`` with a common
    ``Lc = ctx_end - ans_len``), and carries labels only inside its answer
    rows ``[ctx_end, min(ctx_end + ans_len, L))``: all true for real
    encode_gen output.

    Returns (ok [B*R] bool, lc [B*R] int32, rows_max [B*R] int32).
    """
    tokens = np.asarray(batch["tokens"])
    B, R, O, Lx = tokens.shape
    NS = B * R
    toks = tokens.reshape(NS, O, Lx)
    segs = np.asarray(batch["segments"]).reshape(NS, O, Lx)
    labs = np.asarray(batch["mlm_labels"]).reshape(NS, O, Lx)
    mode = np.asarray(batch["mode"]).reshape(NS, O)
    ce = np.asarray(batch["ctx_end"]).reshape(NS, O).astype(np.int64)
    al = np.asarray(batch["ans_len"]).reshape(NS, O).astype(np.int64)

    lc = ce - al
    ok = (mode == 1).all(-1) & (al >= 1).all(-1)
    ok &= (lc == lc[:, :1]).all(-1)
    lc0 = np.clip(lc[:, 0], 0, None)
    ok &= (lc0 >= 2) & (lc0 < Lx)

    j = np.arange(Lx)[None, None, :]
    in_ctx = j < lc0[:, None, None]
    ok &= (~in_ctx | (toks == toks[:, :1])).all((-1, -2))
    ok &= (~in_ctx | (segs == segs[:, :1])).all((-1, -2))

    T = np.minimum(ce + al, Lx)
    lab_ok = (labs == -1) | ((j >= ce[..., None]) & (j < T[..., None]))
    ok &= lab_ok.all((-1, -2))

    rows_max = np.clip(T - lc0[:, None], 0, Lx).max(-1).astype(np.int32)
    return ok, lc0.astype(np.int32), rows_max


def pack_option_rows(n, rb: int, p_quantum: int = 256):
    """Bin-pack each slate's per-option answer rows into ``rb``-row blocks.

    Options never straddle an ``rb`` boundary, so row->row attention stays
    inside one block and the answer kernel's block-diagonal bias applies.

    Args:
      n: [G, O] int, rows needed per option (2 * ans_len, truncation-clipped).
      rb: row-block size.
      p_quantum: the packed length is rounded up to a multiple of this.

    Returns (starts [G, O] int64, the packed offset of each option's first
    row; P, the packed length, a multiple of lcm(rb, p_quantum)).
    """
    G, O = n.shape
    cum = np.zeros(G, np.int64)
    starts = np.empty((G, O), np.int64)
    for o in range(O):
        no = n[:, o].astype(np.int64)
        spill = (cum % rb) + no > rb
        cum = np.where(spill, ((cum // rb) + 1) * rb, cum)
        starts[:, o] = cum
        cum += no
    q = rb * p_quantum // math.gcd(rb, p_quantum)
    P = int(-(-int(cum.max()) // q) * q)
    return starts, max(P, q)


class PrefixScorer:
    """Scores generative slates by context prefill + packed answer-rows
    passes on one device.

    ``group``: slates per group; groups share one context bucket Lcb and
    are balanced to equal sizes. ``row_block``: 0 picks the row block per
    group (``_rb_for``), else fixed. Ineligible slates are left to the
    caller (``last_ok`` after ``score_async``).
    """

    _IMG_KEYS = ("image_feat", "image_loc", "image_mask")

    def __init__(self, cfg: VilbertConfig, *, dtype=torch.bfloat16,
                 group: int = 40, bucket_div: int = 8, row_block: int = 0,
                 device="cuda"):
        if cfg.in_batch_pairs or cfg.fast_mode:
            raise ValueError("prefix scoring needs in_batch_pairs and "
                             "fast_mode off")
        self.cfg = cfg
        self.dtype = dtype
        self.group = group
        self._bucket_div = bucket_div
        self._rb = row_block
        self.device = vilbert.resolve_device(device)
        self._ctx_cfg = cfg.replace(attention_impl="xla")
        self._cast = None
        self.last_ok = None

    def _rb_for(self, Lcb: int, need: int) -> int:
        """Row-block size for a group with context bucket ``Lcb`` whose
        largest option needs ``need`` rows: the scorer's fixed
        ``row_block`` if set, else 64 up to Lcb 192 when every option fits,
        256 otherwise (the JAX package's rule, tuned on a TPU v5e and kept
        until the H100 is swept)."""
        if self._rb:
            return self._rb
        return 64 if (Lcb <= 192 and need <= 64) else 256

    def _make_ffn(self, use_kernel: bool, rows: int):
        """The answer pass's FFN: the fused kernel when the kernels are on
        and ``cfg.fused_ffn``, re-blocking the per-group ``rows`` into the
        largest <= 256-row divisor; its plain version otherwise. Raises when
        no divisor exists rather than quietly taking the plain path."""
        cfg = self.cfg
        if not (use_kernel and cfg.fused_ffn):
            def ffn(p_inter, p_out, h):
                return ffn_block_plain(h, p_inter, p_out, act=cfg.hidden_act)
            return ffn
        rbf = next((b for b in (256, 128, 64, 32, 16, 8) if rows % b == 0),
                   None)
        if rbf is None:
            raise ValueError(f"fused FFN: no row block in (256, 128, 64, 32, "
                             f"16, 8) divides the {rows} answer rows")

        def ffn(p_inter, p_out, h):
            g = h.shape[0]
            hb = h.reshape(g * (rows // rbf), rbf, h.shape[-1])
            return ffn_block(hb, p_inter, p_out,
                             act=cfg.hidden_act).reshape(h.shape)
        return ffn

    def _compute_model(self, model):
        """The model in the compute dtype, cast once and reused while the
        source model's parameters are unchanged."""
        versions = tuple(p._version for p in model.parameters())
        if (self._cast is None or self._cast[0] is not model
                or self._cast[1] != versions):
            self._cast = (model, versions,
                          vilbert.cast_floating(model, self.dtype))
        return self._cast[2]

    def _put(self, arrays):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device, non_blocking=True) for k, v in arrays.items()}

    # ------------------------------------------------------------------
    # device passes
    # ------------------------------------------------------------------

    def _context_impl(self, model, ctx_batch):
        cfg = self.cfg
        taps = {"t": [None] * cfg.num_hidden_layers,
                "c_v": [None] * len(cfg.t_biattention_id)}

        def tap(kind, idx, x):
            taps[kind][idx] = x

        unimm.encode(model, self._ctx_cfg, ctx_batch, dtype=self.dtype,
                     tap=tap)
        return {"t": taps["t"], "c_v": [x for x in taps["c_v"]
                                        if x is not None]}

    def _answer_impl_packed(self, model, d_bias, caches, rows, rb: int):
        """Packed-layout answer pass. ``rows`` holds tokens / segments /
        mlm_labels / opt_id / r_in [G, P] (opt_id == O marks packing
        padding; r_in is the row's index inside its option), lc [G],
        ans_len [G, O], image_mask [G, Rg]. Returns ll_sum / ll_mean [G, O].
        """
        cfg = self.cfg
        p = model.bert
        G, P = rows["tokens"].shape
        O = rows["ans_len"].shape[1]
        RB = rb
        if P % RB:
            raise ValueError(f"packed length {P} not a multiple of {RB}")
        PB = P // RB
        dev = rows["tokens"].device
        lc = rows["lc"].long()
        opt = rows["opt_id"].long()
        rin = rows["r_in"].long()
        A_pad = torch.cat([rows["ans_len"].long(),
                           torch.zeros(G, 1, dtype=torch.long, device=dev)], 1)
        A_row = torch.gather(A_pad, 1, opt)
        valid = opt < O
        first = valid & (rin < A_row)
        # gen position ids: the first copy keeps lc + r_in, the masked copy
        # reuses the first copy's positions; packing padding -> 0
        i_glob = lc[:, None] + rin
        pos = torch.where(valid, torch.where(first, i_glob, i_glob - A_row),
                          torch.zeros_like(i_glob))
        x = vilbert.text_embeddings(p.embeddings, cfg,
                                    rows["tokens"].long(),
                                    rows["segments"].long(), pos,
                                    dtype=self.dtype)

        # --- biases (fp32, layer-independent) ---
        neg = masks.NEG_INF
        Lcb = caches["t"][0].shape[1]
        jc = torch.arange(Lcb, device=dev)
        ctx_open = (jc[None, :] >= 1) & (jc[None, :] < lc[:, None])
        b_ctx = torch.where(ctx_open, 0.0, neg).float()[:, None, :]
        # blocked row->row bias [G, PB, RB, RB]: same option AND the
        # within-option rule (first copy causal, masked copy strictly
        # before i - A), self always open
        ob = opt.reshape(G, PB, RB)
        rnb = rin.reshape(G, PB, RB)
        anb = A_row.reshape(G, PB, RB)
        fq = first.reshape(G, PB, RB)[..., :, None]
        same = (ob[..., :, None] == ob[..., None, :]) & (ob[..., :, None] < O)
        rq, ks = rnb[..., :, None], rnb[..., None, :]
        rr_open = same & torch.where(fq, ks <= rq, ks < (rq - anb[..., :, None]))
        rr_open = rr_open | torch.eye(RB, dtype=torch.bool, device=dev)
        b_rr = torch.where(rr_open, 0.0, neg).float()
        b_img = masks.image_self_bias(rows["image_mask"])  # [G, 1, 1, Rg]

        use_kernel = cfg.attention_impl == "pallas_block"
        attn = answer_block if use_kernel else answer_block_plain
        head = xent_head if use_kernel else xent_head_plain
        ffn = self._make_ffn(use_kernel, P)
        nh_t = cfg.num_attention_heads

        def t_layer(lp, x, li):
            ps = lp.attention.self
            tc = caches["t"][li]                            # [G, Lcb, D]
            h = attn(x, vilbert.linear(ps.key, tc),
                     vilbert.linear(ps.value, tc), b_ctx, b_rr,
                     lp.attention, num_heads=nh_t)
            return ffn(lp.intermediate, lp.output, h)

        def c_layer(cp, x, v_in):
            # text side of the connection layer: rows are independent
            # queries over the cached vision stream (plain PyTorch, as the
            # JAX package leaves it to XLA)
            t_out = vilbert.co_text_side(cp, cfg, v_in, x, b_img)
            return ffn(cp.t_intermediate, cp.t_output, t_out)

        enc = p.encoder
        t_start = 0
        for count, t_end in enumerate(cfg.t_biattention_id):
            for i in range(t_start, t_end):
                x = t_layer(enc.layer[i], x, i)
            if cfg.with_coattention:
                x = c_layer(enc.c_layer[count], x, caches["c_v"][count])
            t_start = t_end
        for i in range(t_start, cfg.num_hidden_layers):
            x = t_layer(enc.layer[i], x, i)

        # labels occupy at most half of any option's rows (the masked
        # second copy), so P // 2 gathered positions always suffice
        P_lab = max(8, P // 2)
        pos_l, labs = unimm.label_positions(rows["mlm_labels"].long(), P_lab)
        hid = vilbert.mlm_head_at_positions(model, cfg, x, pos_l)
        decoder = p.embeddings.word_embeddings.weight
        nll = head(hid, decoder, d_bias, labs)               # [G, P_lab]
        # per-option NLL by a one-hot segment sum over the label rows
        opt_l = torch.gather(opt, 1, pos_l)
        onehot = ((opt_l[..., None] == torch.arange(O, device=dev))
                  & (labs != -1)[..., None]).float()
        nll_sum = torch.einsum("gp,gpo->go", nll.float(), onehot)
        cnt = onehot.sum(1)
        return {"ll_sum": -nll_sum,
                "ll_mean": -(nll_sum / torch.clamp(cnt, min=1.0))}

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------

    def score(self, model, batch) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Score the eligible slates of a [B, R, O] batch.

        Returns (scores {ll_sum/ll_mean: [B*R, O] float32; rows of
        ineligible slates undefined}, ok [B*R] bool)."""
        return self.score_async(model, batch)()

    @torch.no_grad()
    def score_async(self, model, batch):
        """Stage and launch every slate group of a batch; return a closure
        that fetches and assembles (scores, ok). Launches are asynchronous
        on the card, so a caller can stage the NEXT batch before finalizing
        this one."""
        tokens = np.asarray(batch["tokens"])
        B, R, O, Lx = tokens.shape
        NS = B * R
        ok, lc, rows_max = slate_eligibility(batch)
        self.last_ok = ok
        scores = {k: np.zeros((NS, O), np.float32)
                  for k in ("ll_sum", "ll_mean")}
        sel = np.nonzero(ok)[0]
        if sel.size == 0:
            return lambda: (scores, ok)

        cast = self._compute_model(model)
        # the fp32 tied-decoder bias, read before the compute-dtype cast
        d_bias = model.cls.predictions.bias.detach().float()
        toks = tokens.reshape(NS, O, Lx)
        segs = np.asarray(batch["segments"]).reshape(NS, O, Lx)
        labs = np.asarray(batch["mlm_labels"]).reshape(NS, O, Lx)
        ce = np.asarray(batch["ctx_end"]).reshape(NS, O).astype(np.int32)
        al = np.asarray(batch["ans_len"]).reshape(NS, O).astype(np.int32)
        img_of_slate = np.repeat(np.arange(B, dtype=np.int64), R)
        imask_h = np.asarray(batch["image_mask"])
        imgs = self._put({k: np.asarray(batch[k]) for k in self._IMG_KEYS})

        T_all = np.minimum(ce + al, Lx)
        n_all = np.clip(T_all - lc[:, None], 0, Lx).astype(np.int64)

        # sort by context length, balance groups to one size per call
        sel = sel[np.argsort(lc[sel], kind="stable")]
        n_groups = max(1, -(-sel.size // self.group))
        gsize = -(-sel.size // n_groups)

        outs = []
        for gi in range(n_groups):
            g = sel[gi * gsize:(gi + 1) * gsize]
            if g.size == 0:
                break
            pad = gsize - g.size
            if pad:
                g = np.concatenate([g, np.repeat(g[-1:], pad)])
            Lcb = masks.quarter_bucket(int(lc[g].max()), Lx,
                                       div=self._bucket_div)
            need = int(n_all[g].max())
            rb = self._rb_for(Lcb, need)
            if need > rb:
                raise NotImplementedError(W_PADDED_NOT_PORTED)

            ctx_batch = self._put(dict(
                tokens=toks[g, 0, :Lcb], segments=segs[g, 0, :Lcb],
                mode=np.ones(g.size, np.int32), ctx_end=lc[g],
                ans_len=np.zeros(g.size, np.int32),
                img_index=img_of_slate[g]))
            ctx_batch.update(imgs)

            gs = g.size
            n = n_all[g]                          # [gs, O] rows per option
            starts, P = pack_option_rows(n, rb)
            reps = n.ravel()
            oid = np.repeat(np.tile(np.arange(O, dtype=np.int64), gs), reps)
            sid = np.repeat(np.repeat(np.arange(gs), O), reps)
            csum = np.concatenate([[0], np.cumsum(reps)[:-1]])
            rin = (np.arange(int(reps.sum()), dtype=np.int64)
                   - np.repeat(csum, reps))
            ppos = np.repeat(starts.ravel(), reps) + rin
            src = lc[g].astype(np.int64)[sid] + rin       # < Lx
            tokens_p = np.zeros((gs, P), np.int32)
            segs_p = np.zeros((gs, P), np.int32)
            labs_p = np.full((gs, P), -1, np.int32)
            opt_p = np.full((gs, P), O, np.int32)
            rin_p = np.zeros((gs, P), np.int32)
            tg, sg, lg = toks[g], segs[g], labs[g]
            tokens_p[sid, ppos] = tg[sid, oid, src]
            segs_p[sid, ppos] = sg[sid, oid, src]
            labs_p[sid, ppos] = lg[sid, oid, src]
            opt_p[sid, ppos] = oid
            rin_p[sid, ppos] = rin
            rows = self._put(dict(
                tokens=tokens_p, segments=segs_p, mlm_labels=labs_p,
                opt_id=opt_p, r_in=rin_p, lc=lc[g], ans_len=al[g],
                image_mask=imask_h[img_of_slate[g]]))
            caches = self._context_impl(cast, ctx_batch)
            res = self._answer_impl_packed(cast, d_bias, caches, rows, rb)
            outs.append((g[:gs - pad] if pad else g, pad, res))

        def finalize():
            for g, pad, res in outs:
                for k in scores:
                    v = res[k].cpu().numpy()
                    scores[k][g] = v[:g.size] if pad else v
            return scores, ok

        return finalize
