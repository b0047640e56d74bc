"""A frozen copy of the port's hash tokenizer (the fallback it uses where no
HuggingFace tokenizer is cached): each word or punctuation mark is one
token, its id a blake2s digest of the lowercased word folded into
[999, vocab); [CLS] 101 before and [SEP] 102 after, the words cut to
max_length - 2.
"""

import hashlib
import re

CLS_ID = 101
SEP_ID = 102
_HASH_FLOOR = 999
_WORD_RE = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")


def word_id(word: str, vocab_size: int) -> int:
    digest = hashlib.blake2s(word.lower().encode(), digest_size=4).digest()
    return _HASH_FLOOR + int.from_bytes(digest, "little") % (
        vocab_size - _HASH_FLOOR)


def token_ids(text: str, vocab_size: int, max_length: int = 512) -> list:
    """The ids of one text, unpadded."""
    words = _WORD_RE.findall(text)[: max_length - 2]
    return [CLS_ID] + [word_id(w, vocab_size) for w in words] + [SEP_ID]
