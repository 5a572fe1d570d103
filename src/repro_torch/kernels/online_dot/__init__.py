"""The fused online inner-product array as a float matmul front-end."""
