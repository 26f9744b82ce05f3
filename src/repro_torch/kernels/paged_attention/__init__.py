"""Paged-KV decode attention: block-table gather through a global page
pool (the serve engine's ``kv_backend="paged"`` decode)."""

from .ops import paged_attention
from .ref import gather_pages, paged_attention_ref, write_token_to_pages

__all__ = ["paged_attention", "paged_attention_ref", "gather_pages",
           "write_token_to_pages"]
