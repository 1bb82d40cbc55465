from .attention import make_causal_mask, scaled_dot_product_attention

__all__ = ["make_causal_mask", "scaled_dot_product_attention"]
