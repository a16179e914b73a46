"""Operations and bytes of one launch of a kernel, one module per kernel:
``count(config, profiles) -> (operations, bytes, peak key)``."""
