"""The dense GQA decoder (llama3 / phi3): RoPE, SwiGLU, GQA attention with
the flash_attention kernel on prefill, and KV-cache decode."""
