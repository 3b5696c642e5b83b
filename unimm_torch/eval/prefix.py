"""Prefix-cache generative scoring: prefill each slate's shared context once,
then score all answer options against the cached context K/V.

The port of the JAX package's ``eval/prefix.py``. Under the
generative masks the context rows and the whole vision stream of a slate
are identical across its options at every layer (context rows never attend
[CLS] or either answer copy; the image stream attends only context
columns). So per slate:

1. **Context prefill**: one plain encoder forward over the context only
   (descriptor ``mode=gen, ctx_end=Lc, ans_len=0``), tapping each text
   layer's input and each connection layer's vision input.
2. **Answer pass**: only the ``2 * ans_len`` answer rows of every option
   run through the text stream; their queries attend the cached context
   K/V plus their own option's rows. The rows are packed contiguously into
   row blocks (``packed``, the default), or, when ``packed`` is off or a
   group's largest option needs more rows than its row block, each option
   is padded to W rows (16, 32, ... up to the sequence length) and
   ``pick_o_blk(O, W)`` options make one row block of ``Rw`` rows (the W
   layout).
   Under ``attention_impl="pallas_block"`` each text layer is one
   ``answer_block`` kernel plus one ``ffn_block`` kernel, each connection
   layer a plain co-attention over the cached vision stream plus one
   ``ffn_block``, and the label head is the ``xent_head`` kernel; under
   ``"xla"`` and ``"pallas"`` (the JAX package gates these kernels on
   ``"pallas_block"`` alone) the same three steps run their plain
   versions.

Exact up to float rounding: masked columns add exp(-1e4) = 0 to the fp32
softmax, so the scores equal the flat full-forward scores
(``models/unimm.forward_eval``).

In a data-parallel world of several processes (``split_rows``) every rank
stages the same global grouping from the same batch, scores its
contiguous share of each group's slates (the prefill and the answer pass,
so K1, K2 and K3 run on each rank's share) and the [G, O] scores are
all-gathered: the JAX package's multi-process prefix serving.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from unimm_torch.config import VilbertConfig
from unimm_torch.models import unimm, vilbert
from unimm_torch.ops import masks
from unimm_torch.ops.answer_block import (answer_block, answer_block_plain,
                                          answer_chunk_table, block_rr_bias,
                                          pick_o_blk)
from unimm_torch.ops.ffn_block import ffn_block, ffn_block_plain
from unimm_torch.ops.xent_head import xent_head, xent_head_plain
from unimm_torch.parallel import dist
from unimm_torch.utils import trace


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


def answer_biases(lc, opt, rin, A_row, O: int, Lcb: int, RB: int):
    """The answer pass's layer-independent additive fp32 biases of packed
    rows: ``b_ctx`` [G, 1, Lcb], context keys open on [1, lc), and the
    blocked row->row ``b_rr`` [G, PB, RB, RB]: same option AND the
    within-option rule (first copy causal, masked copy strictly before
    i - A), self always open. ``lc`` [G]; ``opt`` (O marks packing
    padding), ``rin`` (the row's index inside its option) and ``A_row``
    (its option's ans_len) [G, P]."""
    neg = masks.NEG_INF
    G, P = opt.shape
    PB = P // RB
    dev = opt.device
    jc = torch.arange(Lcb, device=dev)
    ctx_open = (jc[None, :] >= 1) & (jc[None, :] < lc[:, None])
    b_ctx = torch.where(ctx_open, 0.0, neg).float()[:, None, :]
    first = (opt < O) & (rin < A_row)
    ob = opt.reshape(G, PB, RB)
    rnb = rin.reshape(G, PB, RB)
    anb = A_row.reshape(G, PB, RB)
    fq = first.reshape(G, PB, RB)[..., :, None]
    same = (ob[..., :, None] == ob[..., None, :]) & (ob[..., :, None] < O)
    rq, ks = rnb[..., :, None], rnb[..., None, :]
    rr_open = same & torch.where(fq, ks <= rq, ks < (rq - anb[..., :, None]))
    rr_open = rr_open | torch.eye(RB, dtype=torch.bool, device=dev)
    return b_ctx, torch.where(rr_open, 0.0, neg).float()


def w_layout_biases(lc, A, W: int, Lcb: int):
    """The W layout's layer-independent additive fp32 biases: ``b_ctx`` [G,
    1, Lcb], context keys open on [1, lc), and ``b_rr`` [G, O / o_blk, Rw,
    Rw] with Rw = o_blk W, o_blk = ``pick_o_blk(O, W)``: each option's W
    rows attend only that option's rows, the first copy (rows < A)
    causally, the rest the first copy strictly before i - A and themselves
    (``block_rr_bias``). ``lc`` [G]; ``A`` [G, O] the options' ans_len."""
    G, O = A.shape
    dev = A.device
    jc = torch.arange(Lcb, device=dev)
    ctx_open = (jc >= 1) & (jc < lc[:, None])                 # [G, Lcb]
    b_ctx = torch.where(ctx_open, 0.0, masks.NEG_INF).float()[:, None]
    r = torch.arange(W, device=dev)
    rq, ks = r[:, None], r[None, :]
    A4 = A[..., None, None]
    rr_open = torch.where(rq < A4, ks <= rq, (ks < rq - A4) | (ks == rq))
    return b_ctx, block_rr_bias(rr_open, pick_o_blk(O, W))


class PrefixScorer:
    """Scores generative slates by context prefill + answer-rows passes
    (packed or W-padded) on one device.

    ``group``: slates per group; groups share one context bucket Lcb and
    are balanced to equal sizes. ``packed``: the packed answer layout
    (default), else the W layout for every group. ``row_block``: 0 picks
    the packed row block per group (``_rb_for``), else fixed; a group
    whose largest option needs more rows takes the W layout.
    ``compute_models``: the ``vilbert.ComputeModels`` cache of
    compute-dtype copies to use (one of its own by default; the evaluator
    shares its cache). Ineligible slates are left to the caller
    (``last_ok`` after ``score_async``). ``split_rows``: in a world of
    several processes, group sizes are rounded up to a multiple of the dp
    size and each dp index scores block ``dist.row_block`` of every group
    (the ranks of an mp group the same block).
    """

    _IMG_KEYS = ("image_feat", "image_loc", "image_mask")

    def __init__(self, cfg: VilbertConfig, *, dtype=torch.bfloat16,
                 group: int = 40, bucket_div: int = 8, packed: bool = True,
                 row_block: int = 0, compute_models=None, split_rows=False,
                 device="cuda"):
        if cfg.in_batch_pairs or cfg.fast_mode:
            raise ValueError("prefix scoring needs in_batch_pairs and "
                             "fast_mode off")
        self.cfg = cfg
        self.dtype = dtype
        self.group = group
        self._bucket_div = bucket_div
        self.packed = packed
        self._rb = row_block
        self._world = dist.dp_size() if split_rows else 1
        self.device = vilbert.resolve_device(device)
        self._ctx_cfg = cfg.replace(attention_impl="xla")
        self._compute_model = (compute_models if compute_models is not None
                               else vilbert.ComputeModels(dtype))
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

    def _make_ffn(self, use_kernel: bool):
        """The answer pass's FFN: the fused kernel when the kernels are on
        and ``cfg.fused_ffn``, its plain version otherwise. The kernel takes
        the answer rows as they are, whatever their count (the packed P or
        the W layout's O * W a slate): its products run over all the rows
        of the call as one M, with partial last tiles, so no row block has
        to divide them (the JAX package re-blocks them into a <= 256-row
        divisor for its VMEM, and takes its plain FFN when there is none)."""
        cfg = self.cfg
        fn = ffn_block if use_kernel and cfg.fused_ffn else ffn_block_plain

        def ffn(p_inter, p_out, h):
            return fn(h, p_inter, p_out, act=cfg.hidden_act)
        return ffn

    def _put(self, arrays, rows=slice(None)):
        """Host arrays on the device, each cut to ``rows`` of its first
        axis."""
        with trace.span("eval.h2d"):
            return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(
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

    def _text_stream(self, model, x, caches, b_ctx, b_rr, image_mask):
        """The answer rows x [G, Pr, D] through the text stream: per text
        layer one answer block on the blocked biases (b_ctx [G, 1, Lcb],
        b_rr [G, Pr / RB, RB, RB]) and one FFN, per connection layer the
        plain co-attention over the cached vision stream and one FFN."""
        cfg = self.cfg
        b_img = masks.image_self_bias(image_mask)            # [G, 1, 1, Rg]
        use_kernel = cfg.attention_impl == "pallas_block"
        if use_kernel and x.device.type == "cuda":
            # the kernel's chunk states, built once and shared by the layers
            attn = functools.partial(
                answer_block, table=answer_chunk_table(b_ctx, b_rr))
        elif use_kernel:
            attn = answer_block          # runs its plain version on the CPU
        else:
            attn = answer_block_plain
        ffn = self._make_ffn(use_kernel)
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

        enc = model.bert.encoder
        t_start = 0
        for count, t_end in enumerate(cfg.t_biattention_id):
            for i in range(t_start, t_end):
                x = t_layer(enc.layer[i], x, i)
            if cfg.with_coattention:
                x = c_layer(enc.c_layer[count], x, caches["c_v"][count])
            t_start = t_end
        for i in range(t_start, cfg.num_hidden_layers):
            x = t_layer(enc.layer[i], x, i)
        return x

    def _label_nll(self, model, d_bias, x, labels, n_lab):
        """The label head at each row of x [N, Pr, D]'s first ``n_lab``
        labelled positions: (nll [N, n_lab] fp32, labels there, -1 unused,
        positions [N, n_lab])."""
        cfg = self.cfg
        pos_l, labs = unimm.label_positions(labels, n_lab)
        hid = vilbert.mlm_head_at_positions(model, cfg, x, pos_l)
        head = (xent_head if cfg.attention_impl == "pallas_block"
                else xent_head_plain)
        return head(hid, model.bert.embeddings.word_embeddings.weight,
                    d_bias, labs), labs, pos_l

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
        Lcb = caches["t"][0].shape[1]
        b_ctx, b_rr = answer_biases(lc, opt, rin, A_row, O, Lcb, RB)
        x = self._text_stream(model, x, caches, b_ctx, b_rr,
                              rows["image_mask"])

        # labels occupy at most half of any option's rows (the masked
        # second copy), so P // 2 gathered positions always suffice
        labs_in = rows["mlm_labels"].long()
        nll, labs, pos_l = self._label_nll(model, d_bias, x, labs_in,
                                           max(8, P // 2))   # [G, P_lab]
        # per-option NLL by a one-hot segment sum over the label rows
        opt_l = torch.gather(opt, 1, pos_l)
        onehot = ((opt_l[..., None] == torch.arange(O, device=dev))
                  & (labs != -1)[..., None]).float()
        nll_sum = torch.einsum("gp,gpo->go", nll.float(), onehot)
        cnt = onehot.sum(1)
        return {"ll_sum": -nll_sum,
                "ll_mean": -(nll_sum / torch.clamp(cnt, min=1.0))}

    def _answer_impl(self, model, d_bias, caches, rows):
        """W-layout answer pass (the JAX package's ``_answer_impl``): each
        option's rows padded to W. ``rows`` holds tokens / segments /
        mlm_labels [G, O, W] (the sequence's columns lc .. lc + W - 1),
        lc [G], ans_len / ctx_end [G, O], image_mask [G, Rg]. The rows run
        as [G, O * W] in row blocks of ``Rw = pick_o_blk(O, W) * W`` rows
        (``block_rr_bias``: no row attends another option's rows), the
        JAX kernel path's layout, on the kernels and on their plain
        versions alike. Returns ll_sum / ll_mean [G, O]."""
        cfg = self.cfg
        p = model.bert
        G, O, W = rows["tokens"].shape
        dev = rows["tokens"].device
        lc = rows["lc"].long()                                # [G]
        A = rows["ans_len"].long()                            # [G, O]
        ce = rows["ctx_end"].long()
        r_ids = torch.arange(W, device=dev)
        i_glob = lc[:, None, None] + r_ids                    # [G, 1, W]
        first = r_ids < A[..., None]                          # [G, O, W]
        T = torch.clamp(ce + A, max=cfg.max_seq_len)
        n_rows = torch.clamp(T - lc[:, None], 0, W)
        valid = r_ids < n_rows[..., None]
        # gen position ids: the first copy keeps i, the masked copy reuses
        # the first copy's positions (i - A); padding rows -> 0
        pos = torch.where(valid, torch.where(first, i_glob,
                                             i_glob - A[..., None]),
                          torch.zeros_like(i_glob))
        x = vilbert.text_embeddings(p.embeddings, cfg,
                                    rows["tokens"].long(),
                                    rows["segments"].long(), pos,
                                    dtype=self.dtype)
        b_ctx, b_rr = w_layout_biases(lc, A, W, caches["t"][0].shape[1])
        x = self._text_stream(model, x.reshape(G, O * W, -1), caches,
                              b_ctx, b_rr, rows["image_mask"])

        # labels sit on second-copy rows, at most W // 2 an option
        n_lab = max(8, W // 2)
        nll, labs, _ = self._label_nll(
            model, d_bias, x.reshape(G * O, W, -1),
            rows["mlm_labels"].long().reshape(G * O, W), n_lab)
        cnt = (labs != -1).float().sum(-1)
        nll_sum = nll.float().sum(-1)
        return {"ll_sum": (-nll_sum).reshape(G, O),
                "ll_mean": (-(nll_sum / torch.clamp(cnt, min=1.0))).reshape(
                    G, O)}

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------

    def _pack_rows(self, g, n, rb, O, toks, segs, labs, lc, al, image_mask,
                   rows):
        """Stage group ``g``'s answer rows in the packed layout: ``n`` [gs,
        O] rows per option, bin-packed into ``rb``-row blocks
        (``pack_option_rows``, over the whole group); the dict
        ``_answer_impl_packed`` takes, cut to the slates ``rows``."""
        gs = g.size
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
        return self._put(dict(
            tokens=tokens_p, segments=segs_p, mlm_labels=labs_p,
            opt_id=opt_p, r_in=rin_p, lc=lc[g], ans_len=al[g],
            image_mask=image_mask), rows)

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
        this one.

        While ``utils.trace`` records, each group counts its rows:
        ``eval.rows_needed.prefill`` the real context tokens of its real
        slates against ``eval.rows_launched.prefill``, slates times Lcb;
        ``eval.rows_needed.answer`` their options' answer rows against
        ``eval.rows_launched.answer``, slates times P (packed) or O * W (the
        W layout); a rank counts the slates it scores."""
        tokens = np.asarray(batch["tokens"])
        B, R, O, Lx = tokens.shape
        NS = B * R
        with trace.span("eval.plan"):
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

        with trace.span("eval.plan"):
            T_all = np.minimum(ce + al, Lx)
            n_all = np.clip(T_all - lc[:, None], 0, Lx).astype(np.int64)

            # sort by context length, balance groups to one size per call;
            # under split_rows a multiple of the world, each rank's block
            sel = sel[np.argsort(lc[sel], kind="stable")]
            n_groups = max(1, -(-sel.size // self.group))
            gsize = -(-sel.size // n_groups)
            gsize = -(-gsize // self._world) * self._world
            mine = (dist.row_block(gsize, over=dist.DP) if self._world > 1
                    else slice(None))

        outs = []
        for gi in range(n_groups):
            with trace.span("eval.plan"):
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
                if trace.recording():
                    # this rank's slates, and which of them are not padding
                    real = (np.arange(g.size) < g.size - pad)[mine]
                    trace.count("eval.rows_needed.prefill",
                                lc[g][mine][real].sum())
                    trace.count("eval.rows_launched.prefill",
                                real.size * Lcb)
                    trace.count("eval.rows_needed.answer",
                                n_all[g][mine][real].sum())
            with trace.span("eval.pack"):
                ctx_batch = self._put(dict(
                    tokens=toks[g, 0, :Lcb], segments=segs[g, 0, :Lcb],
                    mode=np.ones(g.size, np.int32), ctx_end=lc[g],
                    ans_len=np.zeros(g.size, np.int32),
                    img_index=img_of_slate[g]), mine)
            ctx_batch.update(imgs)
            with trace.span("eval.prefill"):
                caches = self._context_impl(cast, ctx_batch)
            g_out = g[:g.size - pad] if pad else g

            if self.packed and need <= rb:
                with trace.span("eval.pack"):
                    rows = self._pack_rows(g, n_all[g], rb, O, toks, segs,
                                           labs, lc, al,
                                           imask_h[img_of_slate[g]], mine)
                trace.count("eval.rows_launched.answer",
                            rows["tokens"].numel())
                with trace.span("eval.answer"):
                    outs.append((g_out, pad, self._answer_impl_packed(
                        cast, d_bias, caches, rows, rb)))
                continue

            # the W layout: each option's rows padded to W (16, 32, ...
            # up to Lx)
            with trace.span("eval.pack"):
                need = max(1, int(rows_max[g].max()))
                W = 16
                while W < need:
                    W *= 2
                W = min(W, Lx)
                idx = (lc[g][:, None, None]
                       + np.arange(W, dtype=np.int64)[None, None, :])
                in_range = idx < Lx
                take = np.broadcast_to(np.minimum(idx, Lx - 1),
                                       (g.size, O, W))

                def _rows(a, fill):
                    v = np.take_along_axis(a[g], take, axis=-1)
                    return np.where(in_range, v, fill).astype(a.dtype)

                rows = self._put(dict(
                    tokens=_rows(toks, 0), segments=_rows(segs, 0),
                    mlm_labels=_rows(labs, -1), lc=lc[g], ans_len=al[g],
                    ctx_end=ce[g], image_mask=imask_h[img_of_slate[g]]),
                    mine)
            trace.count("eval.rows_launched.answer", rows["tokens"].numel())
            with trace.span("eval.answer"):
                outs.append((g_out, pad, self._answer_impl(cast, d_bias,
                                                           caches, rows)))

        def finalize():
            keys = sorted(scores)
            local = np.stack([[res[k].cpu().numpy() for k in keys]
                              for _, _, res in outs])   # [groups, keys, gs, O]
            if self._world > 1:
                local = np.concatenate(
                    dist.allgather_np(local, over=dist.DP), axis=2)
            for (g, pad, _), v in zip(outs, local):
                for k, vk in zip(keys, v):
                    scores[k][g] = vk[:g.size] if pad else vk
            return scores, ok

        return finalize
