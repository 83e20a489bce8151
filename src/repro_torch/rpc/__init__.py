"""The serving layer's wire protocol (twin of ``repro.rpc.protocol``).

Only `protocol` is ported so far: `repro_torch.serving.ServeEngine`
catches its `RPCError`.  The batcher, server, client, resilience and
chaos modules follow with the `obs` port.
"""
from repro_torch.rpc.protocol import (PROTOCOL_VERSION, Request, Response,
                                      RPCError, decode_request,
                                      decode_response, encode_request,
                                      encode_response)

__all__ = ["PROTOCOL_VERSION", "Request", "Response", "RPCError",
           "decode_request", "decode_response", "encode_request",
           "encode_response"]
