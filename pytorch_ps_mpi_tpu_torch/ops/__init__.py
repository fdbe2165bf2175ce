"""Hand-written CUDA kernels of the port, with their plain PyTorch
versions: ``sign`` (the 1-bit sign pack/unpack of ``SignCodec``),
``quant`` (int8 quantize and dequantize-sum), ``topk`` (exact top-k's
radix select and compaction), ``tern`` (TernGrad's pack and unpack-sum) and
``attention`` (flash attention, forward and backward)."""
