"""Default values for the simulator core API: a copy of the JAX package's
``simulators/tpu/defaults.py`` (itself the reference's
``simulators/carla/defaults.py`` without camera configurations).
"""

# Simulator frames per second (defaults.py:21).
SIMULATOR_FPS = 20

# The goal sensor configuration (defaults.py:138-142).
GOAL_SENSOR_CONFIG = {
    "num_goals": 10,
    "sampling_radius": 2.0,
    "replan_every_steps": 5,
}

# The game state configuration (defaults.py:145-149).
GAME_STATE_CONFIG = {
    "margin": 150,
    "scale": 1.0,
    "pixels_per_meter": 5,
}

# Default sensors (defaults.py:152-166).
CARLA_SENSORS = (
    "goal",
    "lidar",
    "bird_view_camera_cityscapes",
    "bird_view_camera_rgb",
    "control",
    "location",
    "rotation",
    "velocity",
    "collision",
    "lane_invasion",
    "is_at_traffic_light",
    "traffic_light_state",
)

# Available towns (defaults.py:176-182).
AVAILABLE_CARLA_TOWNS = (
    "Town01",
    "Town02",
    "Town03",
    "Town04",
    "Town05",
)

# Speed configuration of autopilot, km/h (defaults.py:185).
TARGET_SPEED = 20.0

# The number of simulator steps before termination (defaults.py:188).
MAX_EPISODE_STEPS = int(1e4)

# Warm-up steps executed on reset (the reference runs 50 no-op steps to let
# the LocalPlanner/traffic settle; here zero-action world steps).
WARMUP_STEPS = 50

# Image geometry.
BIRD_VIEW_IMAGE_SIZE = 200      # defaults.py:97-101
FRONT_CAMERA_IMAGE_SIZE = (180, 320)  # defaults.py:24-28
LIDAR_IMAGE_SIZE = 200

# Default fixed NPC/pedestrian array capacities when not specified.
DEFAULT_ROUTE_CAPACITY = 2048
