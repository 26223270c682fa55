from knnsvc_torch.utils.layer_weights import generate_matrix_from_index, retrieve_index_from_matrix

__all__ = ["generate_matrix_from_index", "retrieve_index_from_matrix"]
