"""The decoder of the five LM archs: RoPE, SwiGLU and MoE FFNs, GQA
attention (the flash_attention kernel on prefill, Gemma's local:global
windows) and MLA, and cached decode."""
