"""Flash attention: dense causal prefill attention
(``csrc/flash_attention.cu``) and the causal attention of a prefill chunk
over the page pool (``csrc/paged_prefill.cu``)."""
