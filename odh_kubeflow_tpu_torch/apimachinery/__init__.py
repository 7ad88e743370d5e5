from .errors import (
    AdmissionDeniedError,
    AlreadyExistsError,
    ApiError,
    ConflictError,
    ForbiddenError,
    GoneError,
    InvalidError,
    NotFoundError,
    TooManyRequestsError,
    UnauthorizedError,
    ignore_not_found,
    is_already_exists,
    is_conflict,
    is_not_found,
)
from .labels import LabelSelector, LabelSelectorRequirement, match_labels
from .meta import (
    Condition,
    GroupVersionKind,
    KubeObject,
    ObjectMeta,
    OwnerReference,
    controller_owner,
    get_condition,
    now_rfc3339,
    parse_time,
    rfc3339,
    rfc3339_precise,
    sanitize_name,
    set_condition,
)
from .patch import annotation_patch, json_merge_patch, json_patch_apply, json_patch_diff
from .restmapper import RESTMapper, RESTMapping, default_rest_mapper, pluralize
from .scheme import Scheme, default_scheme
from .serde import KubeModel, jfield, snake_to_camel
