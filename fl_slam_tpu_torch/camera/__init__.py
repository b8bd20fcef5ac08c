"""Host-side camera staging (port of ``fl_slam_tpu/camera``): native feature
extraction from an RGB-D frame and its fusion with the lidar depth, into
the camera rows of the measurement batch."""
