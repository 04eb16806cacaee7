# Copied from floxer_tpu/utils/mathutils.py; relative imports resolve to this package's copies.
"""Small integer/float helpers with the reference's exact semantics.

Reference parity: include/math.hpp (saturate_value_to_int32_max math.hpp:10-16,
ceil_div math.hpp:18-20, floating_point_error_aware_ceil math.hpp:22-27;
behavior pinned by test/math_test.cpp).
"""

import math

INT32_MAX = 2**31 - 1

_EPSILON = 1e-9


def saturate_to_int32_max(value: int) -> int:
    """Clamp a non-negative integer to the int32 maximum (math.hpp:10-16)."""
    return INT32_MAX if value > INT32_MAX else int(value)


def ceil_div(a: int, b: int) -> int:
    """Ceiling integer division for non-negative ints (math.hpp:18-20)."""
    return a // b + 1 if a % b else a // b


def float_aware_ceil(value: float) -> int:
    """Epsilon-corrected ceiling, returned as int (math.hpp:22-27).

    Subtracts an epsilon so that ceil doesn't round 5.000000001 up to 6, which
    is load-bearing for error-count derivation: ceil(500 * 0.01) must be 5 and
    ceil(100 * 0.07) must be 7 (test/math_test.cpp:20-25).
    """
    return int(math.ceil(value - _EPSILON) + _EPSILON)
