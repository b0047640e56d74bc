"""The benchmark's arithmetic against counts made by hand."""

from nwbench import yardstick


def test_flops_per_token_e5_large():
    # per layer: QKVO 4 x 1024^2 = 4,194,304; MLP 2 x 1024 x 4096 =
    # 8,388,608; attention 2 x 128 x 1024 = 262,144 multiply-adds
    per_layer = 4_194_304 + 8_388_608 + 262_144
    assert yardstick.flops_per_token(1024, 4096, 24, 128) \
        == 2 * 24 * per_layer


def test_text_flops_each_at_its_own_length():
    a = yardstick.flops_per_token(8, 16, 2, 3)
    b = yardstick.flops_per_token(8, 16, 2, 5)
    assert yardstick.text_flops(8, 16, 2, [3, 5]) == 3 * a + 5 * b


def test_screen_bound_dbpedia():
    q, b, d = 10_000, 990_000, 1536
    assert yardstick.knn_flops(q, b, d) == 3.04128e13
    # 9 mega-tiles of 114,688 rows, 512 int32 keys each, per query
    assert yardstick.screen_bytes(q, b, d) \
        == 2 * (q + b) * d + q * 9 * 512 * 4
    # compute-bound: 30.4128 TFLOP at 989 TFLOP/s
    assert abs(yardstick.screen_bound_s(q, b, d) - 3.04128e13 / 989e12) \
        < 1e-12


def test_screen_bound_small_base_is_bytes_bound():
    q, b, d = 10, 100_000, 1536
    mega_keys = 10 * 4 * 512 * 4          # 4 mega-tiles of 28,672 rows
    assert yardstick.screen_bytes(q, b, d) == 2 * (q + b) * d + mega_keys
    assert yardstick.screen_bound_s(q, b, d) \
        == yardstick.screen_bytes(q, b, d) / yardstick.PEAK_HBM_BYTES
