"""Conference mixing: the mix-minus mixer and the dominant-speaker detector."""
