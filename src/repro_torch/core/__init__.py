"""Analytics and the IMC layer of the port."""
