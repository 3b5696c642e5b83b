"""Self-contained WordPiece tokenizer (BERT-uncased semantics).

The port's copy of the JAX package's ``data/tokenizer.py`` (numpy and the
standard library only; held equal to it in tests/test_torch_data.py).

The reference depends on pytorch_transformers' BertTokenizer downloading
``bert-base-uncased`` at runtime (the reference's
dataloader/dataloader_visdial.py:56). The framework should need no network
and no deep-learning library for tokenization, so this
is a from-scratch implementation of the standard BERT basic+WordPiece
pipeline: lowercasing, accent stripping (NFD), punctuation/CJK splitting,
then greedy longest-match-first subword segmentation with the ``##``
continuation prefix. Given the same ``vocab.txt`` it produces the same
tokens and ids as HuggingFace's BertTokenizer — proven by a 500+-string
unicode fuzz suite (CJK, Hangul, accents/combining marks, control chars,
zero-width, emoji, NBSP, >=100-char words, mixed scripts) against the HF
implementation as oracle (tests/test_tokenizer.py::test_hf_parity_fuzz_*).
scripts/download_vocab.sh fetches the real bert-base-uncased vocab.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Sequence


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
            (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF) or
            (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F) or
            (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF) or
            (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], *, lowercase: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.lowercase = lowercase
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word
        self.cls_id = vocab.get("[CLS]")
        self.sep_id = vocab.get("[SEP]")
        self.mask_id = vocab.get("[MASK]")
        self.pad_id = vocab.get("[PAD]", 0)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    # -- basic tokenization --------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _split_basic(self, text: str) -> List[str]:
        text = self._clean(text)
        # CJK chars become isolated tokens
        spaced = []
        for ch in text:
            if _is_cjk(ord(ch)):
                spaced.append(f" {ch} ")
            else:
                spaced.append(ch)
        words = "".join(spaced).split()
        out: List[str] = []
        for word in words:
            if self.lowercase:
                word = word.lower()
                word = "".join(c for c in unicodedata.normalize("NFD", word)
                               if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur: List[str] = []
            for ch in word:
                if _is_punctuation(ch):
                    if cur:
                        out.append("".join(cur))
                        cur = []
                    out.append(ch)
                else:
                    cur.append(ch)
            if cur:
                out.append("".join(cur))
        return out

    # -- wordpiece -----------------------------------------------------------
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._split_basic(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str) -> List[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in self.tokenize(text)]

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.ids_to_tokens.get(i, self.unk_token) for i in ids]
        text = " ".join(toks).replace(" ##", "")
        return text


def load_tokenizer(vocab_path: str) -> WordPieceTokenizer:
    return WordPieceTokenizer.from_vocab_file(vocab_path)
