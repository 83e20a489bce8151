"""Operations and bytes: of a model's training step (`moe`, `ssm`, by
family) and of one call of a kernel's op at its shapes (`gmm`, `flash`,
`ssd_scan`), from the published arithmetic, not from the port."""

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def itemsize(dtype: str) -> int:
    return _ITEMSIZE[dtype]
