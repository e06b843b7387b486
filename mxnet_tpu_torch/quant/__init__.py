"""Post-training quantization: the PyTorch port of `mxnet_tpu.quant`.

One symmetric per-channel codec (`codec`: int8, and fp8 e4m3 as
``torch.float8_e4m3fn``) serves the serving weights
(``MXNET_SERVE_QUANT=int8|fp8``: `serving.TransformerKVModel` quantizes
its matmul weights once at load and runs scaled matmuls), the int8 paged
K/V pool (``MXNET_SERVE_KV_QUANT``, int8 by default whenever weight quant
is on: int8 rows with a per-row f32 scale beside each block) and the
dist-PS wire format (`encode_wire` / `decode_wire`).
`parity.parity_report` measures a quantized model against its
full-precision oracle: first-decision logit error and the greedy
token-match rate.
"""
from .codec import (QuantSpec, WIRE_GROUP, decode_wire, dequantize,
                    encode_wire, fp8_supported, quantize, quantize_rows,
                    resolve, wire_nbytes)
from .parity import greedy_paged, parity_report

__all__ = ["QuantSpec", "resolve", "fp8_supported", "quantize",
           "dequantize", "quantize_rows", "encode_wire", "decode_wire",
           "wire_nbytes", "WIRE_GROUP", "greedy_paged", "parity_report"]
