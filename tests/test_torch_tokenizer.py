"""The port's stdlib-re CLIP tokenizer against the JAX package's
regex-based one: token arrays equal exactly."""

import numpy as np
import pytest

from dropclip_tpu.teachers import tokenizer as jtok
from dropclip_tpu_torch.teachers import tokenizer as ttok

PROMPTS = [
    "the red mug", "a bowl", "object", "",
    "It's a DOG's toy, isn't it? We'll see; they'd've... I'M sure",
    "3 apples & 12 pears -- 50% off!! 2024-06-01 3.14159",
    "x\u00b2 + \u00bd \u2153 \u216b \u0663\u0664 \uff13 \u2460",
    "caf\u00e9 na\u00efve r\u00e9sum\u00e9 \u00dcn\u00efc\u00f6d\u00e9",
    "\u4e2d\u6587 \u65e5\u672c\u8a9e \ud55c\uad6d\uc5b4 "
    "\u041f\u0440\u0438\u0432\u0435\u0442 \u043c\u0438\u0440",
    "emoji \U0001f600\U0001f44d\U0001f3fd \U0001f468\u200d\U0001f469",
    "tabs\tand\nnewlines  and\u00a0nbsp\u3000ideo\u2003em",
    "&amp; &lt;b&gt; &#39;quoted&#39; &amp;amp;",
    "\u00c3\u00a9t\u00c3\u00a9 mojibake",
    "under_score snake_case CamelCase",
    "a\u0301 combining e\u0308",
    "<|endoftext|> special <|startoftext|>",
    "Kelvin \u212a \u0130stanbul stra\u00dfe \u01c5",
    "\x1c\x1dsep\x1e\x1f", "$100.00 #tag @user ~/path {x}",
]


def test_tokens_equal_jax():
    np.testing.assert_array_equal(ttok.tokenize(PROMPTS),
                                  jtok.tokenize(PROMPTS))


@pytest.mark.parametrize("text", PROMPTS[4:10])
def test_encode_decode_roundtrip_matches(text):
    a = ttok.default_tokenizer().encode(text)
    assert a == jtok.default_tokenizer().encode(text)
    assert ttok.default_tokenizer().decode(a) == \
        jtok.default_tokenizer().decode(a)


def test_context_length_and_truncation():
    long = " ".join(["word"] * 100)
    with pytest.raises(RuntimeError):
        ttok.tokenize(long)
    got = ttok.tokenize(long, truncate=True)
    np.testing.assert_array_equal(got, jtok.tokenize(long, truncate=True))
    assert got.shape == (1, 77) and got[0, -1] == ttok.default_tokenizer().eot
