"""The truncated digit-plane matmul (tpmm) behind the tpmm8 / tpmm16 modes."""
