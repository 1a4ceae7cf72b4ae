"""Wire serialization — the paper's HTTP/1.1+JSON vs gRPC+protobuf contrast.

``JsonVerbose``  : stdlib json over an OpenAI-chat-completion-chunk style
                   envelope — what a FastAPI gateway streams (baseline).
``BinaryCompact``: msgpack over positional tuples — the protobuf stand-in the
                   ScaleLLM gateway uses (compact framing, C-speed codec).

Both are REAL codecs measured end-to-end; bytes-on-wire and encode/decode CPU
are genuine, the network itself is a latency model (gateway.py).

msgpack is imported on ``BinaryCompact``'s first use, once, so the JSON codec
works where msgpack is not installed.
"""
from __future__ import annotations

import functools
import json
import time
from typing import Any, Dict, Tuple


@functools.cache
def _msgpack():
    import msgpack
    return msgpack


class JsonVerbose:
    name = "json-http1"

    @staticmethod
    def encode_request(req_id: str, tokens, params: Dict[str, Any]) -> bytes:
        d = {
            "id": req_id,
            "object": "chat.completion.request",
            "model": params.get("model", "repro"),
            "messages": [{"role": "user", "content": " ".join(map(str, tokens))}],
            "prompt_tokens": [int(t) for t in tokens],
            "temperature": params.get("temperature", 0.5),
            "top_p": params.get("top_p", 0.7),
            "max_tokens": params.get("max_new_tokens", 64),
            "stream": True,
        }
        if params.get("greedy"):
            d["greedy"] = True
        if params.get("deadline_s") is not None:
            d["deadline_s"] = float(params["deadline_s"])
        return json.dumps(d).encode()

    @staticmethod
    def decode_request(data: bytes) -> Tuple[str, list, Dict[str, Any]]:
        d = json.loads(data)
        params = dict(d)
        params["max_new_tokens"] = d.get("max_tokens", 64)
        return d["id"], d["prompt_tokens"], params

    @staticmethod
    def encode_token(req_id: str, token: int, index: int, finished: bool) -> bytes:
        return json.dumps({
            "id": req_id,
            "object": "chat.completion.chunk",
            "created": int(time.time()),
            "model": "repro",
            "choices": [{
                "index": 0,
                "delta": {"role": "assistant", "content": f"<tok:{token}>"},
                "token_id": int(token),
                "token_index": int(index),
                "finish_reason": "stop" if finished else None,
            }],
        }).encode()

    @staticmethod
    def decode_token(data: bytes) -> Tuple[str, int, int, bool]:
        d = json.loads(data)
        c = d["choices"][0]
        return d["id"], c["token_id"], c["token_index"], c["finish_reason"] is not None


class BinaryCompact:
    name = "msgpack-grpc"

    @staticmethod
    def encode_request(req_id: str, tokens, params: Dict[str, Any]) -> bytes:
        return _msgpack().packb((req_id, [int(t) for t in tokens],
                              params.get("temperature", 0.5),
                              params.get("top_p", 0.7),
                              params.get("max_new_tokens", 64),
                              bool(params.get("greedy", False)),
                              params.get("deadline_s")))

    @staticmethod
    def decode_request(data: bytes) -> Tuple[str, list, Dict[str, Any]]:
        parts = _msgpack().unpackb(data)
        req_id, tokens, temp, top_p, mnt = parts[:5]
        params: Dict[str, Any] = {"temperature": temp, "top_p": top_p,
                                  "max_new_tokens": mnt}
        # trailing fields are optional: old 5-tuple frames still decode
        if len(parts) > 5 and parts[5]:
            params["greedy"] = True
        if len(parts) > 6 and parts[6] is not None:
            params["deadline_s"] = parts[6]
        return req_id, tokens, params

    @staticmethod
    def encode_token(req_id: str, token: int, index: int, finished: bool) -> bytes:
        return _msgpack().packb((req_id, int(token), int(index), finished))

    @staticmethod
    def decode_token(data: bytes) -> Tuple[str, int, int, bool]:
        return tuple(_msgpack().unpackb(data))  # type: ignore[return-value]


CODECS = {"json": JsonVerbose, "binary": BinaryCompact}
