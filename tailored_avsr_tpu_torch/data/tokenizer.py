"""Text tokenization: char and word tokenizers, token<->id conversion,
optional SentencePiece BPE (counterpart of ``tailored_avsr_tpu/data/tokenizer.py``;
SPM trainer settings: user symbols <blank>,<sos/eos>, unk_id=1, no
bos/eos/pad).

Token-list files are one token per line: index 0 = <blank>, 1 = <unk>,
last = <sos/eos>; a literal space is written as <space> (char lists only).
sentencepiece is imported only when an SPM model is asked for, and its
absence raises there (the flagship configs use char).
"""

from __future__ import annotations

import os
from typing import List, Sequence


def load_token_list(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return [line.rstrip() for line in f if line.rstrip()]


class CharTokenizer:
    """espnet-style char tokenizer: every char is a token, ' ' -> space_symbol."""

    def __init__(self, space_symbol: str = "<space>"):
        self.space_symbol = space_symbol

    def text2tokens(self, text: str) -> List[str]:
        return [self.space_symbol if c == " " else c for c in text]

    def tokens2text(self, tokens: Sequence[str]) -> str:
        return "".join(" " if t == self.space_symbol else t for t in tokens)


class SPMTokenizer:
    """SentencePiece BPE tokenizer (requires the sentencepiece package)."""

    def __init__(self, model_path: str):
        try:
            import sentencepiece as spm
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "sentencepiece is not installed in this environment; "
                "use token_type='char' or install sentencepiece"
            ) from e
        self.sp = spm.SentencePieceProcessor()
        self.sp.load(model_path)

    def text2tokens(self, text: str) -> List[str]:
        return self.sp.encode_as_pieces(text)

    def tokens2text(self, tokens: Sequence[str]) -> str:
        return self.sp.decode_pieces(list(tokens))


def train_spm_model(
    texts: Sequence[str], model_prefix: str, vocab_size: int = 256
) -> str:
    """Train an SPM BPE model with the reference's settings; returns .token path."""
    try:
        import sentencepiece as spm
    except ImportError as e:  # pragma: no cover
        raise ImportError("sentencepiece is required to train an SPM model") from e
    training_path = model_prefix + ".training"
    with open(training_path, "w", encoding="utf-8") as w:
        for t in texts:
            w.write(t.strip().upper().replace("{", "").replace("}", "") + "\n")
    spm.SentencePieceTrainer.train(
        f"--input={training_path} --model_prefix={model_prefix} "
        "--user_defined_symbols=<blank>,<sos/eos> --unk_id=1 --bos_id=-1 "
        f"--eos_id=-1 --pad_id=-1 --vocab_size={vocab_size}"
    )
    sp = spm.SentencePieceProcessor()
    sp.load(model_prefix + ".model")
    token_path = model_prefix + ".token"
    with open(token_path, "w", encoding="utf-8") as w:
        for i in range(vocab_size):
            w.write(sp.id_to_piece(i) + "\n")
    return token_path


class WordTokenizer:
    def text2tokens(self, text: str) -> List[str]:
        return text.split()

    def tokens2text(self, tokens: Sequence[str]) -> str:
        return " ".join(tokens)


class TokenIDConverter:
    def __init__(self, token_list: Sequence[str], unk_symbol: str = "<unk>"):
        self.token_list = list(token_list)
        self.token2id = {t: i for i, t in enumerate(self.token_list)}
        if unk_symbol not in self.token2id:
            raise ValueError(f"{unk_symbol} missing from token list")
        self.unk_id = self.token2id[unk_symbol]

    def get_num_vocabulary_size(self) -> int:
        return len(self.token_list)

    def tokens2ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.token2id.get(t, self.unk_id) for t in tokens]

    def ids2tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.token_list[int(i)] for i in ids]


def get_tokenizer_converter(config):
    """(tokenizer, converter) for the config's ``token_type`` and ``token_list``."""
    token_type = getattr(config, "token_type", "char")
    token_list_path = config.token_list
    if isinstance(token_list_path, str) and os.path.exists(token_list_path):
        token_list = load_token_list(token_list_path)
    else:
        token_list = list(token_list_path)
    if token_type is None:
        tokenizer = None
    elif token_type == "bpe":
        bpemodel = getattr(config, "bpemodel", None)
        tokenizer = SPMTokenizer(bpemodel) if bpemodel else None
    elif token_type == "char":
        tokenizer = CharTokenizer()
    elif token_type == "word":
        tokenizer = WordTokenizer()
    elif token_type == "phn":
        raise NotImplementedError(
            "token_type 'phn' needs an external grapheme-to-phoneme model "
            "(espnet uses g2p_en/pyopenjtalk), unavailable in this "
            "network-free build; use char/bpe/word"
        )
    elif token_type == "whisper":
        raise NotImplementedError(
            "token_type 'whisper' needs OpenAI Whisper's external tokenizer "
            "assets, unavailable in this network-free build; use char/bpe/word"
        )
    else:
        raise ValueError(f"unsupported token_type: {token_type}")
    converter = TokenIDConverter(token_list)
    return tokenizer, converter
