"""The solve stack: layouts, precision, It-Inv-TRSM at p = 1, the
factor bank, the compiled-program cache and the serving front door."""
