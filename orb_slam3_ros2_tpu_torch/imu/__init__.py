"""IMU preintegration, VI initialization and the Madgwick filter (torch)."""
