"""Host-side native helpers of the port, built with `g++` at first use."""
