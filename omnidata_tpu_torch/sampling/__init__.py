from .poisson import (
    find_building_floors,
    poisson_disc_2d,
    sample_camera_locations_building,
    sample_camera_locations_object,
    sample_camera_yaw_roll,
)
from .points import (
    generate_points,
    in_frustum,
    line_of_sight_matrix,
    obliqueness_matrix,
    prune_points,
    sample_fov,
    sample_surface_points,
)
from .schema import (
    file_name_for,
    load_point_info,
    parse_filename,
    save_camera_poses,
    save_point_info,
)
from .trajectory import frame_uuid, interpolate_trajectory, order_cameras_chain
