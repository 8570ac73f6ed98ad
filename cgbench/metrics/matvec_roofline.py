"""matvec_roofline: the product's least time (its bytes at the card's HBM
peak, or its operations at the float32 peak, counted from the matrix's n,
distinct entries and k) over its device time per product in the traced
calls, in %. The product's kernels are those one call of the operator's
``matvec`` or ``matvec_multi`` ran alone in set-up; a stopped lap's launch
counts neither as a product nor toward their time (``trace.product_seconds``)."""


def read(record):
    t = record["trace"]
    if not t or not t.get("product_s") or not t.get("least_product_s"):
        return None
    return 100.0 * t["least_product_s"] / t["product_s"]
