"""Prefix-cache generative scoring for a causal decoder (the DeepSeek-V3
language model of ``models/deepseek_v3.py``): each slate's shared context
(its dialog's image tokens, then the text of the history and the question)
is prefilled once into the latent cache, then all its options' answers
are scored against that cache as packed causal rows.

A decoder slate batch ([B, R, O] slates) holds ``tokens`` [B, R, O, L]
(the text context on [0, ctx_end), then the answer, its end token last, on
[ctx_end, ctx_end + ans_len)), ``ctx_end`` and ``ans_len`` [B, R, O] and
the dialog's image tokens: ``image_embeds`` [B, Ni, H] (the vision
projector's outputs), ``image_len`` [B]. An option's score is
ll_sum = sum over its answer tokens a_1 .. a_n and the end token of
log p(token | image tokens, context, the answer before it); ll_mean its
mean over those n + 1 tokens.

Per group of slates (sorted by context length):

1. **Prefill** (``eval.prefill``): the contexts as one padded batch of
   ``Lcb`` positions (a multiple of 64), every layer's MLA in the expanded
   form (``mla_expanded``); projections and MLPs run on the real tokens
   only. The per-layer cache is MLA's latent, cat(c_kv, k_pe): 576 values
   a position. The final norm's output at each context's last position
   gives its options' first log-prob.
2. **Answer pass** (``eval.answer``): the options' input rows (the answer
   tokens but the end token) bin-packed into row blocks
   (``prefix.pack_option_rows``), each layer's MLA in the absorbed form
   against the cache and the option's earlier rows (``mla_absorbed``),
   then the LM head over every label row (``ops/xent_head``: K3 at width
   2048 on the card).

While ``utils.trace`` records, each group counts
``eval.rows_needed.prefill`` (real context tokens) against
``eval.rows_launched.prefill`` (slates times Lcb) and
``eval.rows_needed.answer`` against ``eval.rows_launched.answer`` (slates
times the packed length). Inside a ``utils.trace`` capture each group
keeps ``eval.rows``, its rows' places: ``slates`` (the batch's slates in
the group), ``ctx_rows`` (each prefill row's slate in the group and
position) and ``ans_rows`` (each answer row's slate, option and row), in
the order of the rows whose experts each MoE layer keeps (``moe.route``:
the prefill's layers, then the answer pass's).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from unimm_torch.eval.prefix import pack_option_rows
from unimm_torch.models import deepseek_v3 as dsv3
from unimm_torch.ops.xent_head import xent_head
from unimm_torch.utils import trace

CTX_QUANTUM = 64      # context buckets: multiples of this
ROW_BLOCK = 64        # the answer rows' block (an option's rows at most)


def decoder_eligibility(batch) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ok [B*R] bool, lc [B*R], the shared text context length, and A
    [B*R, O], the answer lengths with the end token): a slate qualifies
    when its options share one context length and its tokens, and every
    answer has a token and its end token inside the sequence."""
    tokens = np.asarray(batch["tokens"])
    B, R, O, L = tokens.shape
    toks = tokens.reshape(B * R, O, L)
    ce = np.asarray(batch["ctx_end"]).reshape(B * R, O).astype(np.int64)
    al = np.asarray(batch["ans_len"]).reshape(B * R, O).astype(np.int64)
    ok = (ce == ce[:, :1]).all(-1) & (al >= 2).all(-1) & (ce[:, 0] >= 1)
    ok &= (ce + al <= L).all(-1)
    in_ctx = np.arange(L)[None, None, :] < ce[:, :1, None]
    ok &= (~in_ctx | (toks == toks[:, :1])).all((-1, -2))
    return ok, ce[:, 0].astype(np.int64), al


class DecoderPrefixScorer:
    """Scores decoder slates by a context prefill and a packed answer
    pass on one device. ``group``: slates a group. An option's rows never
    straddle a row block (``ROW_BLOCK``); a slate whose options have more
    input rows than a block, or that is not eligible
    (``decoder_eligibility``), raises."""

    def __init__(self, cfg, *, group: int = 80, device="cuda"):
        self.cfg = cfg
        self.group = group
        self.rb = ROW_BLOCK
        self.device = torch.device(device)

    def _put(self, arrays):
        with trace.span("eval.h2d"):
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device, non_blocking=True) for k, v in arrays.items()}

    def score(self, model, batch):
        return self.score_async(model, batch)()

    @torch.no_grad()
    def score_async(self, model, batch):
        """Stage and launch every group of a [B, R, O] decoder batch;
        return a closure that fetches (scores {ll_sum, ll_mean: [B*R, O]
        float32}, ok [B*R])."""
        tokens = np.asarray(batch["tokens"])
        B, R, O, L = tokens.shape
        NS = B * R
        with trace.span("eval.plan"):
            ok, lc, A = decoder_eligibility(batch)
            if not ok.all():
                raise ValueError(
                    f"decoder scoring: slates {np.nonzero(~ok)[0][:8]} do "
                    "not share a context or have no answer and end token")
            ni = np.asarray(batch["image_len"]).astype(np.int64)
            dialog = np.repeat(np.arange(B), R)
            n_ctx = ni[dialog] + lc                            # [NS]
            n_rows = A - 1                                     # [NS, O]
            if int(n_rows.max()) > self.rb:
                raise ValueError(f"an option of {int(n_rows.max())} rows "
                                 f"exceeds the row block {self.rb}")
            order = np.argsort(n_ctx, kind="stable")
            toks = tokens.reshape(NS, O, L)
        with trace.span("eval.h2d"):
            img = torch.from_numpy(np.ascontiguousarray(
                batch["image_embeds"])).to(self.device, non_blocking=True)
        Ni = img.shape[1]
        img = img.reshape(B * Ni, -1)
        outs = []
        for g0 in range(0, NS, self.group):
            g = order[g0:g0 + self.group]
            outs.append((g, self._group(model, g, toks, lc[g], A[g],
                                        n_ctx[g], dialog[g] * Ni, img)))

        def finalize():
            scores = {k: np.zeros((NS, O), np.float32)
                      for k in ("ll_sum", "ll_mean")}
            for g, res in outs:
                ll = res.cpu().numpy()
                scores["ll_sum"][g] = ll
                scores["ll_mean"][g] = ll / A[g]
            return scores, ok

        return finalize

    def _group(self, model, g, toks, lc, A, n_ctx, img0, img):
        """Launch one group's prefill, answer pass and head; its ll_sum
        [gs, O] on the device."""
        gs, O = A.shape
        n_rows = A - 1
        with trace.span("eval.plan"):
            Lcb = int(-(-int(n_ctx.max()) // CTX_QUANTUM) * CTX_QUANTUM)
            starts, P = pack_option_rows(n_rows, self.rb)
            if trace.recording():
                trace.count("eval.rows_needed.prefill", n_ctx.sum())
                trace.count("eval.rows_launched.prefill", gs * Lcb)
                trace.count("eval.rows_needed.answer", n_rows.sum())
                trace.count("eval.rows_launched.answer", gs * P)
        with trace.span("eval.pack"):
            ctx = self._pack_context(g, toks, lc, n_ctx, img0, Lcb)
            ans = self._pack_answers(g, toks, lc, A, n_ctx, starts, P)
            if trace.capturing():
                at = ans["slot"]
                trace.keep("eval.rows", dict(
                    slates=g, ctx_rows=np.stack([ctx["slot"] // Lcb,
                                                 ctx["slot"] % Lcb]),
                    ans_rows=np.stack([at // P, ans["opt"][at],
                                       ans["rin"][at]])))
        ctx, ans = self._put(ctx), self._put(ans)
        with trace.span("eval.prefill"):
            x = model.embed.index_select(0, ctx["tok"]).float()
            x.index_copy_(0, ctx["img_at"],
                          img.index_select(0, ctx["img_row"]).float())
            h_ctx, caches = dsv3.prefill(model, x, ctx["slot"], gs, Lcb)
            last = h_ctx.index_select(0, ctx["last"])            # [gs, H]
        with trace.span("eval.answer"):
            rows = dsv3.AnswerRows.build(ans["slot"], ans["opt"], ans["rin"],
                                         ans["n_ctx"], gs, P, self.rb, Lcb)
            xa = model.embed.index_select(0, ans["tok"])
            h_ans = dsv3.answer(model, xa, ans["pos"], caches, rows)
            # the label rows: each option's first token from its context's
            # last position, then one a row
            hid = torch.cat([last.repeat_interleave(O, 0), h_ans])
            lab = torch.cat([ans["first_label"], ans["label"]])
            nll = xent_head(hid.contiguous(), model.lm_head, None, lab)
            # each option's rows (at most rb), gathered and summed in order
            pad = torch.cat([nll[gs * O:], nll.new_zeros(1)])
            ll = -(nll[:gs * O] + pad[ans["opt_rows"]].sum(-1))
        return ll.view(gs, O)

    def _pack_context(self, g, toks, lc, n_ctx, img0, Lcb):
        """The group's context rows, slate-major: token id (0 at image
        rows), the image rows' indices and their source rows, padded slot
        (slate Lcb + position), and each slate's last row."""
        gs = g.size
        n = n_ctx.astype(np.int64)
        ni = n - lc
        total = int(n.sum())
        sid = np.repeat(np.arange(gs), n)
        first = np.concatenate([[0], np.cumsum(n)[:-1]])
        pos = np.arange(total) - np.repeat(first, n)
        is_img = pos < np.repeat(ni, n)
        tcol = np.clip(pos - np.repeat(ni, n), 0, None)
        tok = np.where(is_img, 0, toks[g[sid], 0, tcol]).astype(np.int64)
        img_row = (np.repeat(img0, n) + pos)[is_img]
        return dict(tok=tok, img_at=np.nonzero(is_img)[0], img_row=img_row,
                    slot=sid * Lcb + pos, last=first + n - 1)

    def _pack_answers(self, g, toks, lc, A, n_ctx, starts, P):
        """The group's answer rows in option-major order (slate, option,
        row): token, position, packed slot, label (the next answer token);
        per packed slot its option (O at padding) and row index; each
        option's first label and its rows' indices (into the label rows
        after the first ones; -1 padding: the zero appended)."""
        gs, O = A.shape
        n = (A - 1).ravel()                                   # [gs O]
        total = int(n.sum())
        sid = np.repeat(np.repeat(np.arange(gs), O), n)
        oid = np.repeat(np.tile(np.arange(O), gs), n)
        first = np.concatenate([[0], np.cumsum(n)[:-1]])
        rin = np.arange(total) - np.repeat(first, n)
        col = lc[sid] + rin
        at = (g[sid], oid)
        slot = sid * P + starts.ravel()[sid * O + oid] + rin
        opt_p = np.full(gs * P, O, np.int64)
        rin_p = np.zeros(gs * P, np.int64)
        opt_p[slot] = oid
        rin_p[slot] = rin
        width = int(n.max())
        opt_rows = np.full((gs * O, width), total, np.int64)
        opt_rows[np.repeat(np.arange(gs * O), n), rin] = np.arange(total)
        return dict(
            tok=toks[at + (col,)], pos=n_ctx[sid] + rin, slot=slot,
            label=toks[at + (col + 1,)],
            first_label=toks[np.repeat(g, O), np.tile(np.arange(O), gs),
                             np.repeat(lc, O)],
            opt=opt_p, rin=rin_p, n_ctx=n_ctx, opt_rows=opt_rows)
