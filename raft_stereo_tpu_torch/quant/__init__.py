"""Post-training int8 inference tier of the port: weight and activation
quantizers (``core``), the int8 x int8 -> int32 encoder convs
(``matmul``) and calibration with its scale file (``calibrate``)."""
