"""The reduction of a device trace to a product's time."""

from cgbench.trace import product_seconds

K, FILL = "well_rows_spmv_kernel", "FillFunctor"


def _events(products, fills):
    out, t = [], 0.0
    for d in products:
        out.append((K, t, t + d))
        t += 100.0
    for _ in range(fills):
        out.append((FILL, t, t + 2.0))
        t += 10.0
    return out


def test_a_product_is_a_launch_of_its_main_kernel_and_a_stopped_lap_is_none():
    """A stopped lap's launch is neither a product nor part of one's time."""
    sec, n = product_seconds(_events([25.0, 25.0, 26.0, 0.5], 0), [K])
    assert n == 3 and abs(sec - 76e-6 / 3) < 1e-12


def test_a_kernel_launched_more_often_than_the_product_is_left_out():
    """A fill that the probe's call ran, and that the lap runs besides, is
    not the product's: its launches outnumber the product's."""
    sec, n = product_seconds(_events([25.0, 25.0], 5), [K, FILL])
    assert n == 2 and abs(sec - 25e-6) < 1e-12


def test_a_kernel_launched_once_a_product_counts():
    sec, n = product_seconds(_events([25.0, 25.0], 2), [K, FILL])
    assert n == 2 and abs(sec - 27e-6) < 1e-12


def test_no_product_kernel_reads_nothing():
    assert product_seconds(_events([25.0], 0), []) == (None, 0)
    assert product_seconds(_events([], 3), [K]) == (None, 0)
