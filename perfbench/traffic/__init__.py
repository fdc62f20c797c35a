"""Traffic drivers (one ``Cell`` class each) and the traffic mixes
(``<mix>.json``) that name them."""
