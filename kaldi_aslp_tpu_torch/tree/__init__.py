"""Decision trees for context-dependent phones (port of
kaldi_aslp_tpu/tree/: Gaussian clustering, tree building, the CD-phone
label toolchain; numpy, no torch)."""

from kaldi_aslp_tpu_torch.tree.cluster import (
    GaussStats,
    cluster_bottom_up,
    kmeans_cluster,
    merge_objf_loss,
)
from kaldi_aslp_tpu_torch.tree.build_tree import (
    ContextDependency,
    TreeNode,
    build_tree,
    cluster_phones_into_questions,
    stats_from_alignment,
)
from kaldi_aslp_tpu_torch.tree.cd_phone import (
    acc_tree_stats_cd_phone,
    build_cd_phone_tree,
    compile_questions_phone,
    convert_ali_to_cd_phone,
    tree_bind_info,
)
