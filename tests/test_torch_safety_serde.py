"""The port's safety module (auth/rate-limit/content filter) and wire codecs,
as tests/test_safety_serde.py holds the reference's; then the port's frames
against the reference's, and the JSON codec without msgpack installed."""
import subprocess
import sys
from pathlib import Path

import pytest
pytest.importorskip("hypothesis", reason="hypothesis not installed")
from hypothesis import given, settings, strategies as st

from repro_torch.core.safety import (AuthError, Authenticator, ContentBlocked,
                               ContentFilter, RateLimited, TokenBucket)
from repro_torch.core.serde import CODECS


def test_auth_roundtrip_and_rejection():
    a = Authenticator(secret=b"k")
    tok = a.issue("alice")
    assert a.verify(tok) == "alice"
    with pytest.raises(AuthError):
        a.verify(tok[:-2] + "zz")
    with pytest.raises(AuthError):
        a.verify("malformed")
    with pytest.raises(AuthError):
        Authenticator(secret=b"other").verify(tok)


def test_rate_limiter_enforces_rate():
    rl = TokenBucket(rate=10.0, burst=5.0)
    t = 0.0
    for _ in range(5):
        rl.check("u", now=t)
    with pytest.raises(RateLimited):
        rl.check("u", now=t)
    rl.check("u", now=t + 0.2)          # refilled 2 tokens
    rl.check("other", now=t)            # independent buckets


def test_content_filter():
    cf = ContentFilter(blocked={13, 666})
    cf.check([1, 2, 3])
    with pytest.raises(ContentBlocked):
        cf.check([1, 666, 3])


@pytest.mark.parametrize("codec_name", ["json", "binary"])
def test_codec_roundtrip(codec_name):
    c = CODECS[codec_name]
    raw = c.encode_request("rid-1", [1, 2, 3, 400], {"temperature": 0.3,
                                                     "top_p": 0.9,
                                                     "max_new_tokens": 17})
    rid, toks, params = c.decode_request(raw)
    assert rid == "rid-1" and toks == [1, 2, 3, 400]
    assert params["max_new_tokens"] == 17
    tok_raw = c.encode_token("rid-1", 42, 5, True)
    rid2, tok, idx, fin = c.decode_token(tok_raw)
    assert (rid2, tok, idx, fin) == ("rid-1", 42, 5, True)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 200_000), min_size=1, max_size=64),
       st.integers(0, 1_000_000), st.booleans())
def test_codec_roundtrip_hypothesis(tokens, tok, fin):
    for c in CODECS.values():
        raw = c.encode_request("x", tokens, {})
        _, t2, _ = c.decode_request(raw)
        assert t2 == tokens
        _, tok2, _, fin2 = c.decode_token(c.encode_token("x", tok, 0, fin))
        assert tok2 == tok and fin2 == fin


def test_binary_is_smaller_than_json():
    """The paper's serde claim: compact binary framing beats verbose JSON."""
    toks = list(range(100))
    j = CODECS["json"].encode_request("r", toks, {})
    b = CODECS["binary"].encode_request("r", toks, {})
    assert len(b) < len(j) / 2
    jt = CODECS["json"].encode_token("r", 5, 0, False)
    bt = CODECS["binary"].encode_token("r", 5, 0, False)
    assert len(bt) < len(jt) / 5


frames = st.tuples(
    st.text(max_size=24), st.lists(st.integers(0, 2**31 - 1), max_size=64),
    st.floats(allow_nan=False), st.floats(allow_nan=False), st.integers(0, 2**31 - 1),
    st.booleans(), st.one_of(st.none(), st.floats(allow_nan=False)))


@settings(max_examples=60, deadline=None)
@given(frames, st.integers(-1, 2**31 - 1), st.integers(0, 2**31 - 1), st.booleans())
def test_binary_frames_equal_reference(frame, tok, idx, fin):
    """The port's binary frames are the reference's, byte for byte, for both
    frame shapes (the request 7-tuple, the token 4-tuple), and each side
    decodes the other's."""
    from repro.core.serde import CODECS as REF
    rid, tokens, temp, top_p, mnt, greedy, deadline = frame
    params = {"temperature": temp, "top_p": top_p, "max_new_tokens": mnt,
              "greedy": greedy, "deadline_s": deadline}
    mine = CODECS["binary"].encode_request(rid, tokens, params)
    assert mine == REF["binary"].encode_request(rid, tokens, params)
    assert CODECS["binary"].decode_request(mine) == REF["binary"].decode_request(mine)
    t = CODECS["binary"].encode_token(rid, tok, idx, fin)
    assert t == REF["binary"].encode_token(rid, tok, idx, fin)
    assert CODECS["binary"].decode_token(t) == REF["binary"].decode_token(t) == (rid, tok, idx, fin)


def test_json_frames_decode_across_packages():
    """JSON frames carry a wall-clock field, so they are held by what each
    side decodes from the other's bytes."""
    from repro.core.serde import CODECS as REF
    params = {"temperature": 0.25, "top_p": 0.5, "max_new_tokens": 9, "greedy": True,
              "deadline_s": 1.5}
    for enc, dec in ((CODECS["json"], REF["json"]), (REF["json"], CODECS["json"])):
        assert dec.decode_request(enc.encode_request("q", [5, 6, 7], params)) == \
            enc.decode_request(enc.encode_request("q", [5, 6, 7], params))
        assert dec.decode_token(enc.encode_token("q", 31, 4, False)) == ("q", 31, 4, False)


def test_json_codec_needs_no_msgpack():
    """msgpack is imported on the binary codec's first use: with msgpack
    missing the module imports, JSON round-trips and only binary fails."""
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "from repro_torch.core.serde import CODECS\n"
        "j = CODECS['json']\n"
        "assert j.decode_token(j.encode_token('r', 3, 1, True)) == ('r', 3, 1, True)\n"
        "try:\n"
        "    CODECS['binary'].encode_token('r', 3, 1, True)\n"
        "except ImportError:\n"
        "    print('binary needs msgpack')\n"
    )
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(root / "src"), "PATH": ""}, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "binary needs msgpack"
